"""Global constants (counterpart: sopro_tpu/constants.py)."""

TARGET_SR = 24000
DEFAULT_MIMI_ID = "kyutai/mimi"
