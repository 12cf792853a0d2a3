# Copy of the jax-free parts of mediquery_rag_tpu/app (the port imports nothing of the JAX package).
"""Application layer on the port's side: the structured consultation
(``consultation``) with its risk triage (``risk``), the health calculators
(``tools``), the profile categories and the two-tier memory."""
