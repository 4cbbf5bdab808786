"""Per-partition storage engine: memtable, WAL, columnar SSTs, LSM."""
