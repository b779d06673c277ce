"""The GATv2 + LSTM rank-schedule predictor (inference)."""
