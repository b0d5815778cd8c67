"""Run configurations of the port (this slice: the LDA sweep)."""
