"""Eval-debug outputs: HTML image galleries + embedding CSV dumps.

A copy of ``twingan_tpu/evals/gallery.py``, with PIL imported inside the
functions that write JPEG files.

Reference parity:
- eval HTML writer (model_inheritor.py:897-957 save-images + index.html with
  one column per end point, one row per example);
- embedding CSV output mode (twingan.py:684-729 _define_outputs /
  _write_outputs: filename, flattened 4x4 content encoding [, base64 image]).
"""

from __future__ import annotations

import base64
import csv
import html
import io
import os
from typing import Dict, Optional, Sequence

import numpy as np


def write_html_gallery(
    out_dir: str,
    items: Dict[str, np.ndarray],
    max_rows: int = 64,
    title: str = "eval debug",
) -> str:
    """items: name -> batch. Image batches ([N,H,W,C] float [0,1]) become
    JPEG cells; others are printed as text. Returns the index.html path."""
    from PIL import Image as PILImage

    os.makedirs(out_dir, exist_ok=True)
    names = list(items)
    n = min(max_rows, min(len(v) for v in items.values()))

    def is_image(arr) -> bool:
        arr = np.asarray(arr)
        return arr.ndim == 4 and arr.shape[-1] in (1, 3)

    cells: Dict[str, list] = {}
    for name in names:
        batch = np.asarray(items[name])
        col = []
        for i in range(n):
            if is_image(batch):
                img = np.clip(batch[i] * 255.0, 0, 255).astype(np.uint8)
                if img.shape[-1] == 1:
                    img = img[..., 0]
                fname = f"{name}_{i}.jpg"
                PILImage.fromarray(img).save(os.path.join(out_dir, fname), quality=90)
                col.append(f'<img src="{fname}" />')
            else:
                col.append(f"<pre>{html.escape(np.array2string(batch[i], precision=3))}</pre>")
        cells[name] = col

    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(f"<html><head><title>{html.escape(title)}</title></head><body><table border=1>\n")
        f.write("<tr>" + "".join(f"<th>{html.escape(c)}</th>" for c in names) + "</tr>\n")
        for i in range(n):
            f.write("<tr>" + "".join(f"<td>{cells[c][i]}</td>" for c in names) + "</tr>\n")
        f.write("</table></body></html>\n")
    return path


def write_embeddings_csv(
    path: str,
    filenames: Sequence[str],
    embeddings: np.ndarray,
    images: Optional[np.ndarray] = None,
    append: bool = True,
) -> str:
    """Rows: filename, flattened embedding values [, base64 JPEG]."""
    if images is not None:
        from PIL import Image as PILImage

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = np.asarray(embeddings).reshape(len(filenames), -1)
    mode = "a" if append else "w"
    with open(path, mode, newline="") as f:
        writer = csv.writer(f)
        for i, name in enumerate(filenames):
            row = [name] + [repr(float(v)) for v in flat[i]]
            if images is not None:
                img = np.clip(np.asarray(images[i]) * 255.0, 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                PILImage.fromarray(img).save(buf, format="JPEG")
                row.append(base64.b64encode(buf.getvalue()).decode())
            writer.writerow(row)
    return path
