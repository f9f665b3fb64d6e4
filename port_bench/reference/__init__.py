"""The plain PyTorch reference of the benchmark: front end, model, steps and inputs.
It imports nothing of the program under test."""
