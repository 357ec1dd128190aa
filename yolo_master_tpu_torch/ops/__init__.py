"""Box ops, NMS and the CUDA kernel wrappers of the port."""
