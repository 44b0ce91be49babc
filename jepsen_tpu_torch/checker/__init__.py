"""Checkers of the port: the linearizability dispatcher, its host WGL
search, and the checker protocol."""
