"""The plain reference the benchmark judges the port against: fp32 PyTorch
with no kernel (`nets`, `ransac`), importing nothing of the port."""
