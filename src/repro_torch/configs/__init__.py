"""Run configurations of the port: the LDA sweep, the sampler spec and
gemma2-9b's decode sampler."""
