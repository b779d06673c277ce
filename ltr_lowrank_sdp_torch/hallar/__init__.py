"""HALLaR-class spectraplex solver of the port (``hallar.solver``, ``hallar.cli``)."""
