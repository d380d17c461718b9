"""FaceID embedding ingestion (port of ``ops/face_embed.py``; pure numpy,
the same embeddings bit for bit).

The reference extracts 512-d identity embeddings with insightface
(buffalo_l) from a face crop and feeds them to the FaceID IP-Adapter's MLP
projection (reference: source/app.py:800-825 ``ip_adapter_face_id_embedding``
-> FaceAnalysis.get(...).normed_embedding; consumed at
source/modules/model_k_diffusion.py:173-222).

Embedding contract (what any production embedder must satisfy):
  * shape (512,) float32 per face, L2-normalized (insightface
    ``normed_embedding``);
  * one embedding per reference image; multiple images for the same
    identity may be averaged then re-normalized (the reference stacks them
    per image, app.py:806-817);
  * the FaceID projection consumes a batch (B, 512) and emits
    (B, num_tokens, cross_dim) via ``models.ip_adapter.faceid_projection_apply``.

Without insightface weights the default embedder is a DETERMINISTIC
STUB: a fixed-seed random projection of pooled image statistics. It satisfies the contract (shape, dtype, norm,
determinism: same crop -> same embedding; different crops -> different
embeddings) so the whole FaceID path is e2e-testable offline. Swap in a
real embedder by passing any callable with the same signature to
``IPAdapterUnit.face_embedder``, or register an ArcFace network
(``ModelManager.register_face_embedder``, ``models/arcface.py``).
"""

from __future__ import annotations

import numpy as np

EMBED_DIM = 512
_POOL = 16  # pooled grid; 16*16*3 = 768 input features


def _projection_matrix() -> np.ndarray:
    rng = np.random.RandomState(20240216)
    m = rng.randn(_POOL * _POOL * 3, EMBED_DIM).astype(np.float32)
    return m / np.sqrt(_POOL * _POOL * 3)


_PROJ = _projection_matrix()


def embed_face(image: np.ndarray) -> np.ndarray:
    """Deterministic stub face embedding.

    ``image``: (H, W, 3) uint8 or float face crop. Returns (512,) float32,
    L2-normalized. NOT a real identity embedding — a stand-in that fulfils
    the insightface contract documented above for offline testing.
    """
    img = np.asarray(image)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) face crop, got {img.shape}")
    h, w, _ = img.shape
    # average-pool to a fixed 16x16 grid (nearest binning, pure numpy)
    ys = (np.arange(_POOL) * h // _POOL)
    xs = (np.arange(_POOL) * w // _POOL)
    pooled = img[ys][:, xs]  # (16, 16, 3)
    feats = pooled.reshape(-1) - pooled.mean()
    emb = feats @ _PROJ
    n = np.linalg.norm(emb)
    if n == 0.0:
        emb = _PROJ[0].copy()
        n = np.linalg.norm(emb)
    return (emb / n).astype(np.float32)


def embed_faces(images) -> np.ndarray:
    """Average-and-renormalize multi-image identity embedding (B images of
    one identity -> one (512,) embedding), mirroring common insightface
    usage; stack per-image instead to match app.py:806-817 exactly."""
    embs = np.stack([embed_face(im) for im in images])
    mean = embs.mean(axis=0)
    return (mean / np.linalg.norm(mean)).astype(np.float32)
