"""Plain-JAX operations shared by the model, training and serving paths."""
