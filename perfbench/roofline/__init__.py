"""Operation and byte counts of the kernels and models, and the card's published peaks."""
