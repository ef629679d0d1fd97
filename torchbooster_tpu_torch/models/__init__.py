"""Models of the port (the GPT language model so far)."""
