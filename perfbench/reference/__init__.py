"""Plain PyTorch references of the configurations; nothing of the system under test."""
