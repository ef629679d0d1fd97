"""Recipes of the port: end-to-end scripts built on the package, each the
counterpart of one of the JAX package's ``examples/``."""
