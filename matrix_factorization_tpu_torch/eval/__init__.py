"""Offline evaluation (PyTorch port of ``matrix_factorization_tpu/eval``):
rating metrics, Top-K harness, hybrid ablation, constraint-violation judge
(keywords + optional LLM)."""
