"""Config, optimizer, train state, methods and the trainer of the port."""
