"""The harness of the port's benchmark: cells, configurations and
traffic found by name, the card, the clock, the trace and the result."""
