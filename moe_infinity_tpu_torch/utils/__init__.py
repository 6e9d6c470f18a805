"""Framework-free helpers of the port: dtype names and logging."""
