"""Conformance oracle: decode bitstreams with dav1d and compare planes.

The port's copy of the JAX package's dav1d shim, so that the port's
checks decode without importing the JAX package. Every packet the
encoder emits must decode, and the decoder output must equal the
encoder's own reconstruction bit-exactly.
"""
