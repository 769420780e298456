"""Models: the ViT, its layers and the graph block."""
