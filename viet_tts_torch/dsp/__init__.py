"""Signal processing the port's training losses need."""
