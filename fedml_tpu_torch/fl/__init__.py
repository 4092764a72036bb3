"""Federated-learning building blocks of the port: types, losses, local SGD, the algorithm frame."""
