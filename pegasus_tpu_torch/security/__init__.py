"""At-rest encryption for the port: KMS client and data-key provider."""
