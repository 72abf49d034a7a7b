"""Training: state, optimizer and the JETS adversarial step."""
