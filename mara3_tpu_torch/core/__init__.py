"""Array building blocks shared by the schemes (maps mara3_tpu/core)."""
