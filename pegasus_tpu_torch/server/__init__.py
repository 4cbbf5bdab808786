"""The rrdb storage app for one partition."""
