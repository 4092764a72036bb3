"""Models of the port (CIFAR ResNets) and their factory."""
