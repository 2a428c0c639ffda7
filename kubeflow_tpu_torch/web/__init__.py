"""Web plumbing of the port: the request-framing contract its model
server shares with the JAX package's transports (``http``)."""
