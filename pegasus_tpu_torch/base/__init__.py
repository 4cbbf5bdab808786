"""Key/value schemas and hashing (reference: src/base/)."""
