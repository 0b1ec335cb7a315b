"""Serving: request coalescing over a fitted model, the artifact-backed
recommend service, the meal planner and the HTTP API."""
