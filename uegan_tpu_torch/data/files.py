"""Dataset file discovery (reference: data_loader.py:15-18)."""

from __future__ import annotations

from pathlib import Path
from typing import List

IMAGE_EXTS = ("png", "jpg", "jpeg", "JPG")


def list_image_files(dname) -> List[Path]:
    """Recursively list images under ``dname`` (png/jpg/jpeg/JPG)."""
    out: List[Path] = []
    for ext in IMAGE_EXTS:
        out.extend(Path(dname).rglob(f"*.{ext}"))
    return out
