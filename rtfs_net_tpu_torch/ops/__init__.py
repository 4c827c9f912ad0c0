"""Primitive ops of the port (norms, activations, convs, STFT, SRU)."""
