"""Model substrate of the port: the dense-LM transformer and its blocks."""
