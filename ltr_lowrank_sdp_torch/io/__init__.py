"""Problem readers (SDPA ``.dat-s`` and SuiteSparse ``.mat`` MaxCut)."""
