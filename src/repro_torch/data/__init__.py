"""Token data of the port: `TokenStream` (NumPy, the JAX package's bits)
and the prefetching `Pipeline`."""
