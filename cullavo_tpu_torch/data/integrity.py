"""Dataset integrity check (counterpart of ``cullavo_tpu/data/integrity.py``):
every image an instruction-data JSON names must exist.

    python -m cullavo_tpu_torch.data.integrity rows.json image_root
"""
from __future__ import annotations

import json
import os
import sys


def check_instruction_json(json_file: str, image_root: str) -> dict:
    """``{"total", "missing": [paths], "text_only"}`` of a conversation JSON."""
    with open(json_file) as f:
        rows = json.load(f)
    missing = []
    text_only = 0
    for row in rows:
        img = row.get("image")
        if not img:
            text_only += 1
            continue
        path = os.path.join(image_root, img)
        if not os.path.exists(path):
            missing.append(path)
    return {"total": len(rows), "missing": missing, "text_only": text_only}


if __name__ == "__main__":
    out = check_instruction_json(sys.argv[1], sys.argv[2])
    print(f"total={out['total']} text_only={out['text_only']} missing={len(out['missing'])}")
    for p in out["missing"][:20]:
        print("MISSING", p)
