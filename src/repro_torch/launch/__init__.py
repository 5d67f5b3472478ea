"""Entry points of the port: step functions, the serving loop and the
schedule service."""
