"""Application wiring (``AppContext``) and the terminal flows (``interface``,
``python -m mediquery_rag_tpu_torch.cli``)."""
