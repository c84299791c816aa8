"""Radiology-report extraction (counterpart of
``rsuper_tpu/report_extraction/``): prompts for an OpenAI-compatible LLM
endpoint, parsers of its answers, and the per-tumour and per-CT CSVs that
training and evaluation read."""

from .client import LLMClient
from .parse import parse_lesion_answer
from .metadata import (
    standardize_organ,
    standardize_location,
    classify_lesion,
    build_per_tumor_csv,
    build_per_ct_csv,
)

__all__ = [
    "LLMClient",
    "parse_lesion_answer",
    "standardize_organ",
    "standardize_location",
    "classify_lesion",
    "build_per_tumor_csv",
    "build_per_ct_csv",
]
