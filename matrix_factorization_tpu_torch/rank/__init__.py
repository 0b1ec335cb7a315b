"""Ranking layer: hybrid blending, reranker, hard filters, diversity,
domain (recipe) feature parsers."""
