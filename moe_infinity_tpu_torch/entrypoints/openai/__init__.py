"""The OpenAI-compatible HTTP server of the port (stdlib only)."""
