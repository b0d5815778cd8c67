"""Draw state per strategy (this slice: builders and u-driven draws)."""
