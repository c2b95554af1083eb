"""The port's workflow and its command line."""
