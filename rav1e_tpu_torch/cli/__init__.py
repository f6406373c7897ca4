"""CLI: y4m input, IVF output (reference parity: rav1e src/bin/)."""
