"""The continuous-batching LLM serving engine."""
