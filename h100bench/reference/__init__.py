"""The plain reference the benchmark holds the program against. It imports
nothing of the program and nothing of JAX."""
