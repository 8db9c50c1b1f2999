"""Lip mask extraction for training data (reference
`lip_mask_extractor.py:21-68`: mediapipe FaceMesh lip polygons -> PNG
masks), port of `stableavatar_tpu/preprocess/lip_mask_extractor.py`: host
cv2, no device work.

The fallback chain:

  1. mediapipe FaceMesh lip polygons (when installed -- the reference's);
  2. OpenCV Haar face box -> Haar mouth / smile detection inside the lower
     face -> `lip_geometry_mask`: two half-ellipses approximating the
     FaceMesh upper / lower lip rings, refined by lip chroma (pseudo-hue)
     so the mask hugs actual lip pixels, not a rectangle (a headless cv2
     without objdetect warns and yields empty masks);
  3. no face found -> empty mask (as the reference when FaceMesh finds no
     landmarks).

`lip_geometry_mask` is a pure function over (image, mouth box), held bit
for bit against the JAX package's in tests/test_torch_preprocess.py.
Run: python -m stableavatar_tpu_torch.preprocess.lip_mask_extractor
--frames_dir frames/ --out_dir lip_masks/
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np

# FaceMesh lip landmark rings used when mediapipe is present
UPPER_LIP = [61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291, 308, 415, 310, 311, 312, 13, 82, 81, 80, 191, 78]
LOWER_LIP = [61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291, 308, 324, 318, 402, 317, 14, 87, 178, 88, 95, 78]


def lip_geometry_mask(img_bgr: np.ndarray, mouth_box) -> np.ndarray:
    """Lip-shaped mask inside a detected mouth box.

    Approximates the reference's FaceMesh upper/lower lip polygons
    (`lip_mask_extractor.py:21-68`) with two half-ellipses sharing the mouth
    corners — the upper lip flatter (40% of lip height), the lower fuller
    (60%) — then keeps only pixels whose chroma looks lip-like
    (pseudo-hue r/(r+g+b) above the local median inside the ellipses).  For
    grayscale/low-chroma crops the pure geometry is returned.

    Returns a uint8 [H, W] mask in {0, 255}.
    """
    h, w = img_bgr.shape[:2]
    x0, y0, x1, y1 = [int(v) for v in mouth_box]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w), min(y1, h)
    mask = np.zeros((h, w), np.uint8)
    if x1 <= x0 or y1 <= y0:
        return mask

    cx = (x0 + x1) / 2.0
    cy = (y0 + y1) / 2.0  # lip line (mouth corners level)
    a = (x1 - x0) / 2.0  # half mouth width
    lip_h = y1 - y0
    b_up = max(lip_h * 0.4, 1.0)
    b_lo = max(lip_h * 0.6, 1.0)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx2 = ((xx - cx) / a) ** 2
    upper = (yy <= cy) & (dx2 + ((yy - cy) / b_up) ** 2 <= 1.0)
    lower = (yy > cy) & (dx2 + ((yy - cy) / b_lo) ** 2 <= 1.0)
    geom = upper | lower
    if not geom.any():
        return mask

    img = img_bgr.astype(np.float32)
    if img.ndim == 3 and img.shape[2] >= 3:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        total = r + g + b + 1e-6
        pseudo_hue = r / total
        region = pseudo_hue[geom]
        # lips are redder than the surrounding skin; split the ellipse
        # interior into lip/skin chroma clusters (1-D two-means) when there
        # is usable contrast
        if region.std() > 0.01:
            c0, c1 = np.percentile(region, 25), np.percentile(region, 75)
            for _ in range(8):
                mid = (c0 + c1) / 2.0
                lo_m, hi_m = region[region < mid], region[region >= mid]
                if not len(lo_m) or not len(hi_m):
                    break
                c0, c1 = float(lo_m.mean()), float(hi_m.mean())
            thresh = (c0 + c1) / 2.0
            refined = geom & (pseudo_hue >= thresh)
            # guard against degenerate refinement (e.g. uniform fill)
            if refined.sum() >= 0.15 * geom.sum():
                geom = refined

    mask[geom] = 255
    return mask


def _detect_mouth_box(img_bgr, face_cascade, mouth_cascade):
    """Face box -> mouth box: Haar mouth/smile detection inside the lower
    half of the face, with a proportional fallback placement."""
    import cv2

    if face_cascade is None:
        return None
    gray = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY)
    faces = face_cascade.detectMultiScale(gray, 1.1, 4)
    if len(faces) == 0:
        return None
    x, y, fw, fh = max(faces, key=lambda f: f[2] * f[3])

    roi_y0 = y + int(fh * 0.55)
    roi = gray[roi_y0 : y + fh, x : x + fw]
    if mouth_cascade is not None and not mouth_cascade.empty() and roi.size:
        mouths = mouth_cascade.detectMultiScale(roi, 1.3, 8)
        if len(mouths):
            # lowest detection in the face = the mouth (smile cascade also
            # fires on eyes when run over a whole face)
            mx, my, mw, mh = max(mouths, key=lambda m: m[1])
            return (x + mx, roi_y0 + my, x + mx + mw, roi_y0 + my + mh)
    # proportional placement (FaceMesh lip ring extents on frontal faces)
    return (
        x + int(fw * 0.30),
        y + int(fh * 0.70),
        x + int(fw * 0.70),
        y + int(fh * 0.90),
    )


def extract_lip_masks(frames_dir: str, out_dir: str) -> int:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    names = sorted(os.listdir(frames_dir))

    try:
        import mediapipe as mp

        mesh = mp.solutions.face_mesh.FaceMesh(
            static_image_mode=True, max_num_faces=1, refine_landmarks=True
        )

        def lip_mask(img):
            h, w = img.shape[:2]
            res = mesh.process(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            mask = np.zeros((h, w), np.uint8)
            if res.multi_face_landmarks:
                lm = res.multi_face_landmarks[0].landmark
                for ring in (UPPER_LIP, LOWER_LIP):
                    pts = np.array(
                        [[int(lm[i].x * w), int(lm[i].y * h)] for i in ring], np.int32
                    )
                    cv2.fillPoly(mask, [pts], 255)
            return mask

    except ImportError:
        warnings.warn(
            "mediapipe not installed; using Haar face+mouth detection with "
            "ellipse/chroma lip geometry for lip masks"
        )
        face_cascade = mouth_cascade = None
        try:
            face_cascade = cv2.CascadeClassifier(
                cv2.data.haarcascades + "haarcascade_frontalface_default.xml"
            )
            smile_path = cv2.data.haarcascades + "haarcascade_smile.xml"
            mouth_cascade = (
                cv2.CascadeClassifier(smile_path)
                if os.path.exists(smile_path)
                else None
            )
        except AttributeError:
            # headless cv2 builds ship without objdetect; detection is then
            # unavailable and frames without an override yield empty masks
            warnings.warn(
                "this cv2 build lacks CascadeClassifier (objdetect); "
                "install mediapipe or full opencv for face detection"
            )

        def lip_mask(img):
            box = _detect_mouth_box(img, face_cascade, mouth_cascade)
            if box is None:
                return np.zeros(img.shape[:2], np.uint8)
            return lip_geometry_mask(img, box)

    count = 0
    for n in names:
        img = cv2.imread(os.path.join(frames_dir, n))
        if img is None:
            continue
        cv2.imwrite(os.path.join(out_dir, n), lip_mask(img))
        count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser("lip_mask_extractor")
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out_dir", required=True)
    a = p.parse_args(argv)
    n = extract_lip_masks(a.frames_dir, a.out_dir)
    print(f"wrote {n} masks to {a.out_dir}")


if __name__ == "__main__":
    main()
