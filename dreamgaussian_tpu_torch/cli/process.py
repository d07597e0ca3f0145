"""Input preprocessing: decoding, background matting and recentring.

Port of ``dreamgaussian_tpu/cli/process.py``:

- ``read_image`` (``utils/imread.py``) is the port's ``cv2.imread(path,
  cv2.IMREAD_UNCHANGED)``, channels in RGB(A) order, bit for bit: PNG (every
  colour type and bit depth, Adam7, ``tRNS``), JPEG (Huffman- and
  arithmetic-coded, sequential, progressive and lossless), WebP (lossless,
  lossy, alpha, an animation's first frame), BMP, PNM/PAM, GIF, TIFF
  (strips and tiles, every codec cv2's libtiff decodes; unassociated alpha
  premultiplied as cv2 gives it), JPEG 2000 (JP2 and J2K, Part 1, with
  cv2's channel and colour-space rules), Radiance HDR, PFM and Sun raster
  by the file's leading bytes; AVIF, which cv2 reads, raises
  NotImplementedError naming the format; a file no decoder recognises, or
  one that does not decode (where ``cv2.imread`` returns None), raises
  FileNotFoundError in ``load_rgba``, as the JAX function does;
- the steps after the decode are the JAX function's: grey becomes RGB,
  4-channel inputs keep their alpha (the reference's own inputs are RGBA),
  and the values are divided by 255 whatever the dtype, so a 16-bit input
  comes out with values up to 257 as it does from the JAX package;
- RGB and grey inputs are matted, then recentred: cropped to the alpha's
  box and pasted, scaled to ``(1 - border_ratio) * size``, in the middle
  of a ``size``^2 canvas. The matte is U2Net's from a local checkpoint
  (``--u2net`` or ``DG_U2NET_CKPT``: the official ``u2net.pth`` or
  ``u2netp.pth``, ``preprocess/u2net.py``), else GrabCut's, as the JAX
  package falls back to ``cv2.grabCut`` (``preprocess/grabcut.py``), both
  with their pixel work on the port's device. A named checkpoint that is
  missing raises FileNotFoundError (the JAX package falls back silently);
- resizes are ``utils/resize.py``'s copies of ``cv2.INTER_AREA``;
- ``--caption`` writes a BLIP-2 caption (transformers, from a local
  directory ``--blip_ckpt``).

    python -m dreamgaussian_tpu_torch.cli.process input.jpg [--size 256] \\
        [--u2net u2net.pth] [--device cpu]

writes ``input_rgba.png`` beside the input.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import resolve_device
from ..utils.imread import read_image
from ..utils.png import write_png
from ..utils.resize import resize_area


def remove_background(img: np.ndarray, u2net_ckpt: str | None = None,
                      device="cuda") -> np.ndarray:
    """RGB [H, W, 3] -> RGBA of its dtype: U2Net's uint8 matte stacked on
    it when a checkpoint is given (``u2net_ckpt``, else ``DG_U2NET_CKPT``;
    any dtype, as the JAX function stacks it), GrabCut's otherwise (uint8
    only, as ``cv2.grabCut``)."""
    u2net_ckpt = u2net_ckpt or os.environ.get("DG_U2NET_CKPT")
    if not u2net_ckpt:
        from ..preprocess.grabcut import grabcut_alpha

        if img.dtype != np.uint8:
            raise ValueError(f"GrabCut takes an 8-bit RGB image, as cv2.grabCut does; got "
                             f"{img.dtype} (give U2Net weights, or convert the image to 8 bits)")
        return np.dstack([img, grabcut_alpha(img, device=device)])
    if not os.path.exists(u2net_ckpt):
        raise FileNotFoundError(f"no U2Net checkpoint at {u2net_ckpt}")
    from ..preprocess.u2net import u2net_alpha

    alpha = (u2net_alpha(img, u2net_ckpt, device=device) * 255).astype(np.uint8)
    return np.dstack([img, alpha])


def recenter(rgba: np.ndarray, size: int, border_ratio: float = 0.2) -> np.ndarray:
    """Crop to the alpha's box and paste it, scaled to ``(1 - border_ratio)
    * size`` on its longer side, centred in a ``size``^2 canvas."""
    mask = rgba[..., 3] > 0
    if not mask.any():
        return resize_area(rgba, size, size)
    coords = np.argwhere(mask)
    y0, x0 = coords.min(axis=0)
    y1, x1 = coords.max(axis=0) + 1
    crop = rgba[y0:y1, x0:x1]
    ch, cw = crop.shape[:2]
    desired = int(size * (1 - border_ratio))
    scale = desired / max(ch, cw)
    nh, nw = int(ch * scale), int(cw * scale)
    crop = resize_area(np.ascontiguousarray(crop), nh, nw)
    out = np.zeros((size, size, 4), dtype=rgba.dtype)
    oy = (size - nh) // 2
    ox = (size - nw) // 2
    out[oy:oy + nh, ox:ox + nw] = crop
    return out


def load_rgba(path: str, size: int | None = None, border_ratio: float = 0.2,
              u2net_ckpt: str | None = None, device="cuda") -> np.ndarray:
    """An image (``read_image``) as float32 RGBA at ``size``^2 (or its own
    size), divided by 255: 4-channel inputs keep their alpha; RGB and grey are
    matted (``remove_background``) and recentred. A file that does not
    decode, where ``cv2.imread`` returns None, raises FileNotFoundError as
    the JAX function does."""
    try:
        img = read_image(path)
    except ValueError as err:
        raise FileNotFoundError(f"{path}: {err}") from err
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] not in (3, 4):
        raise ValueError(f"{path}: a {img.shape[-1]}-channel image (3 or 4 are taken, as "
                         f"the JAX package's colour conversion takes them)")
    if img.shape[-1] == 4:
        rgba = img
    else:
        rgba = remove_background(img, u2net_ckpt, device)
        rgba = recenter(rgba, size or max(rgba.shape[:2]), border_ratio)
    if size is not None and rgba.shape[0] != size:
        rgba = resize_area(rgba, size, size)
    return rgba.astype(np.float32) / 255.0


def caption_image(rgb: np.ndarray, blip_ckpt: str, device="cuda") -> str:
    """A BLIP-2 caption of an RGB [H, W, 3] image in [0, 1], from the
    transformers checkpoint in the local directory ``blip_ckpt``."""
    import torch
    from transformers import AutoProcessor, Blip2ForConditionalGeneration

    device = resolve_device(device)
    processor = AutoProcessor.from_pretrained(blip_ckpt)
    model = Blip2ForConditionalGeneration.from_pretrained(
        blip_ckpt, torch_dtype=torch.float32).to(device)
    inputs = processor(images=(rgb * 255).astype(np.uint8), return_tensors="pt").to(device)
    out = model.generate(**inputs, max_new_tokens=30)
    return processor.decode(out[0], skip_special_tokens=True).strip()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch input preprocessing")
    ap.add_argument("path")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--border_ratio", type=float, default=0.2)
    ap.add_argument("--u2net", default=None, help="local u2net(p).pth for the matting")
    ap.add_argument("--caption", action="store_true")
    ap.add_argument("--blip_ckpt", default=None, help="local BLIP-2 directory for --caption")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rgba = load_rgba(args.path, size=args.size, border_ratio=args.border_ratio,
                     u2net_ckpt=args.u2net, device=device)
    out_path = os.path.splitext(args.path)[0] + "_rgba.png"
    write_png(out_path, (rgba * 255).astype(np.uint8))
    print(f"[INFO] wrote {out_path}")
    if args.caption:
        if not args.blip_ckpt:
            raise SystemExit("--caption needs --blip_ckpt <local dir> (no weights ship with the repo)")
        text = caption_image(rgba[..., :3], args.blip_ckpt, device)
        cap_path = os.path.splitext(args.path)[0] + "_caption.txt"
        with open(cap_path, "w") as fh:
            fh.write(text + "\n")
        print(f"[INFO] caption: {text}")
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
