"""Encoder-side analysis: scene detection and the lookahead."""
