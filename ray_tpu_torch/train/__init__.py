"""The single-device training step and its AdamW."""
