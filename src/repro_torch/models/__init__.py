"""Model substrate of the port: the transformer (dense and MoE FFN, the
training loss) and its blocks."""
