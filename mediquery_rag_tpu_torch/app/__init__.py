# Copy of the jax-free parts of mediquery_rag_tpu/app (the port imports nothing of the JAX package).
"""Application layer on the port's side: the health calculators
(``tools``), the profile categories and the two-tier memory."""
