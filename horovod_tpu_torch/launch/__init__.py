"""Entry points: the HTTP generation server."""
