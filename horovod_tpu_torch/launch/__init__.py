"""Entry points: the local multi-process launcher and the HTTP generation
server."""
