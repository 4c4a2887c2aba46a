"""Config-driven model substrate: every family of the ten configs (dense,
vlm, moe, ssm, hybrid, encdec)."""
from .model import ModelApi, get_model
