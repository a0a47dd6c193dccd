"""Video decode and encode (counterpart of the JAX package's ``video``)."""
