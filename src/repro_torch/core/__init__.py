"""Graph preprocessing, the tile pipeline and the counting engines."""
