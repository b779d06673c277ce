"""The predictor's data pipeline: SDPA instance -> graph features, and the
dataset of (graph, rank schedule) pairs."""
