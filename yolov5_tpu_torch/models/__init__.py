"""Model graph, layers and weight conversion."""
