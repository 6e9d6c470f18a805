"""User-facing entry points of the port: the ``MoE`` facade and the OpenAI-compatible server."""
