"""Device operations: NTT, SHA-256, salts, FRI fold."""
