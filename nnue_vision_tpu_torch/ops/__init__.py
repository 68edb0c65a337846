"""Int8 engine simulation and the Hopper kernels of the serving path."""
