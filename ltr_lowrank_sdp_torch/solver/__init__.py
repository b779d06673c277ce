"""The two-phase solver: ALM (phase I), ADMM (phase II), driver."""
