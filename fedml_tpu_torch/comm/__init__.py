"""Communication: messages, the pytree wire format, transports."""
