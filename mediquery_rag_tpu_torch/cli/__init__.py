"""Application wiring (``AppContext``)."""
