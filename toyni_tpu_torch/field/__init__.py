"""BabyBear field arithmetic (int64 tensors) and host helpers."""
