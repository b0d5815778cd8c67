"""Shared draw-tile steps (this slice: their plain versions only)."""
