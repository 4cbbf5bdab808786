"""Error codes and the flag registry."""
