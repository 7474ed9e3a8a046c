"""Training of the port: train state, optimizer and loop."""
