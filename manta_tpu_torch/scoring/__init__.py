"""Split-read scoring routed to the port's device scan."""
