"""Prompt tier: section-composed system prompts."""

from .base import PromptProvider, PromptSection, PromptValidationError
from .v1 import DEFAULT_SANDBOX_ENV, SECTION_FILES, PromptProviderV1

__all__ = [
    "DEFAULT_SANDBOX_ENV",
    "PromptProvider",
    "PromptProviderV1",
    "PromptSection",
    "PromptValidationError",
    "SECTION_FILES",
]
