"""Config-driven model substrate: the dense and vlm transformer families."""
from .model import ModelApi, get_model
