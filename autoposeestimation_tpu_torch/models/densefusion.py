"""DenseFusion pose networks (port of `autoposeestimation_tpu/models/
densefusion.py`), batched with per-sample object ids. Image crops are NCHW;
point features are (B, N, C) so the pointwise layers are Linear layers.
Submodule names follow DenseFusion's `lib/network.py` (`cnn`, `feat.conv1`,
`feat.e_conv1`, ..., heads `conv1_r`..`conv4_r`)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Linear
from .pspnet import PSPNet


def gather_embeddings(emb_map: torch.Tensor,
                      choose: torch.Tensor) -> torch.Tensor:
    """emb_map (B, E, S, S), choose (B, N) flat window indices ->
    (B, N, E)."""
    b, e = emb_map.shape[:2]
    flat = emb_map.reshape(b, e, -1)
    idx = choose.to(torch.int64)[:, None, :].expand(b, e, choose.shape[1])
    return torch.gather(flat, 2, idx).transpose(1, 2)


def gather_embeddings_bilinear(emb_map: torch.Tensor, choose: torch.Tensor,
                               crop: int) -> torch.Tensor:
    """Bilinear sample of a stride-s map (B, E, S/s, S/s) at the full-res
    choose pixels of the (crop, crop) window, pixel-centre mapping
    (coarse = (full + 0.5) / s - 0.5, clamped to the map) -> (B, N, E)."""
    b, e, hc, wc = emb_map.shape
    s = crop // hc
    rows = torch.div(choose, crop, rounding_mode="floor").to(torch.float32)
    cols = (choose % crop).to(torch.float32)
    fr = torch.clamp((rows + 0.5) / s - 0.5, 0.0, hc - 1.0)
    fc = torch.clamp((cols + 0.5) / s - 0.5, 0.0, wc - 1.0)
    r0 = torch.floor(fr).to(torch.int64)
    c0 = torch.floor(fc).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=hc - 1)
    c1 = torch.clamp(c0 + 1, max=wc - 1)
    wr = (fr - r0.to(torch.float32))[..., None]
    wcol = (fc - c0.to(torch.float32))[..., None]

    def take(r, c):
        return gather_embeddings(emb_map, r * wc + c)

    top = take(r0, c0) * (1 - wcol) + take(r0, c1) * wcol
    bot = take(r1, c0) * (1 - wcol) + take(r1, c1) * wcol
    return top * (1 - wr) + bot * wr


class PoseNetFeat(nn.Module):
    """Pointwise fusion features (B, N, 1408): geometry and colour branches
    3/32 -> 64 -> 128, and a 1024-d average-pooled global feature."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Linear(3, 64, dtype)
        self.e_conv1 = Linear(32, 64, dtype)
        self.conv2 = Linear(64, 128, dtype)
        self.e_conv2 = Linear(64, 128, dtype)
        self.conv5 = Linear(256, 512, dtype)
        self.conv6 = Linear(512, 1024, dtype)

    def forward(self, cloud: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(cloud.to(self.dtype)))
        e = F.relu(self.e_conv1(emb.to(self.dtype)))
        pf1 = torch.cat([x, e], dim=-1)
        x = F.relu(self.conv2(x))
        e = F.relu(self.e_conv2(e))
        pf2 = torch.cat([x, e], dim=-1)
        g = F.relu(self.conv6(F.relu(self.conv5(pf2))))
        g = g.mean(dim=1, keepdim=True).expand(-1, pf1.shape[1], -1)
        return torch.cat([pf1, pf2, g], dim=-1)


def _select_object(y: torch.Tensor, obj_idx: torch.Tensor, num_obj: int,
                   out_dim: int) -> torch.Tensor:
    """(B, ..., num_obj*out_dim) -> (B, ..., out_dim) rows of each sample's
    object."""
    y = y.reshape(y.shape[:-1] + (num_obj, out_dim))
    idx = obj_idx.to(torch.int64).reshape((-1,) + (1,) * (y.dim() - 1))
    idx = idx.expand(y.shape[:-2] + (1, out_dim))
    return torch.gather(y, -2, idx).squeeze(-2)


class PoseHead(nn.Module):
    """1408 -> 640 -> 256 -> 128 -> out_dim*num_obj pointwise head; the
    last layer runs in f32."""

    def __init__(self, out_dim: int, num_obj: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim, self.num_obj = out_dim, num_obj
        self.conv1 = Linear(1408, 640, dtype)
        self.conv2 = Linear(640, 256, dtype)
        self.conv3 = Linear(256, 128, dtype)
        self.conv4 = Linear(128, out_dim * num_obj, torch.float32)

    def forward(self, feat: torch.Tensor, obj_idx: torch.Tensor):
        y = F.relu(self.conv3(F.relu(self.conv2(F.relu(self.conv1(feat))))))
        y = self.conv4(y.to(torch.float32))
        return _select_object(y, obj_idx, self.num_obj, self.out_dim)


class PoseNet(nn.Module):
    """(img (B, 3, S, S) normalized crops, cloud (B, N, 3), choose (B, N),
    obj_idx (B,)) -> (pred_r (B, N, 4), pred_t (B, N, 3), pred_c (B, N, 1),
    emb (B, N, 32)). `train=True` turns on the PSPNet's dropout, whose
    masks come from `generator`; `rows` places a data-parallel block in
    its batch (`pspnet.dropout`)."""

    def __init__(self, num_obj: int, dtype: torch.dtype = torch.float32,
                 emb_stride: int = 1, emb_resize_late: bool = False):
        super().__init__()
        self.emb_stride = emb_stride
        self.cnn = PSPNet(dtype=dtype, emb_stride=emb_stride,
                          resize_late=emb_resize_late)
        self.feat = PoseNetFeat(dtype)
        self.head_r = PoseHead(4, num_obj, dtype)
        self.head_t = PoseHead(3, num_obj, dtype)
        self.head_c = PoseHead(1, num_obj, dtype)

    def forward(self, img, cloud, choose, obj_idx, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, ...]:
        emb_map = self.cnn(img, train=train, generator=generator, rows=rows)
        if self.emb_stride > 1:
            emb = gather_embeddings_bilinear(emb_map, choose, img.shape[-1])
        else:
            emb = gather_embeddings(emb_map, choose)
        feat = self.feat(cloud, emb)
        pred_r = self.head_r(feat, obj_idx)
        pred_t = self.head_t(feat, obj_idx)
        pred_c = torch.sigmoid(self.head_c(feat, obj_idx))
        return pred_r, pred_t, pred_c, emb.detach()


class PoseRefineNetFeat(nn.Module):
    """Global refiner feature (B, 1024)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Linear(3, 64, dtype)
        self.e_conv1 = Linear(32, 64, dtype)
        self.conv2 = Linear(64, 128, dtype)
        self.e_conv2 = Linear(64, 128, dtype)
        self.conv5 = Linear(384, 512, dtype)
        self.conv6 = Linear(512, 1024, dtype)

    def forward(self, cloud: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(cloud.to(self.dtype)))
        e = F.relu(self.e_conv1(emb.to(self.dtype)))
        pf1 = torch.cat([x, e], dim=-1)
        x = F.relu(self.conv2(x))
        e = F.relu(self.e_conv2(e))
        pf3 = torch.cat([pf1, torch.cat([x, e], dim=-1)], dim=-1)
        g = F.relu(self.conv6(F.relu(self.conv5(pf3))))
        return g.mean(dim=1)


class RefineHead(nn.Module):
    """1024 -> 512 -> 128 -> out_dim*num_obj. The last layer (f32) starts as
    an exact no-op correction: zero weight, bias = `identity_bias` per
    object, so a fresh refiner returns the estimator's pose."""

    def __init__(self, out_dim: int, num_obj: int,
                 dtype: torch.dtype = torch.float32,
                 identity_bias: Sequence[float] = ()):
        super().__init__()
        self.out_dim, self.num_obj = out_dim, num_obj
        self.identity_bias = tuple(identity_bias)
        self.conv1 = Linear(1024, 512, dtype)
        self.conv2 = Linear(512, 128, dtype)
        self.conv3 = Linear(128, out_dim * num_obj, torch.float32)
        self.reset_identity()

    def reset_identity(self) -> None:
        if not self.identity_bias:
            return
        with torch.no_grad():
            self.conv3.weight.zero_()
            self.conv3.bias.copy_(torch.tensor(
                self.identity_bias, dtype=torch.float32).repeat(self.num_obj))

    def forward(self, feat: torch.Tensor, obj_idx: torch.Tensor):
        y = F.relu(self.conv2(F.relu(self.conv1(feat))))
        y = self.conv3(y.to(torch.float32))
        return _select_object(y, obj_idx, self.num_obj, self.out_dim)


class PoseRefineNet(nn.Module):
    """(cloud (B, N, 3), emb (B, N, 32), obj_idx (B,)) -> (pred_r (B, 4),
    pred_t (B, 3)): one global correction."""

    def __init__(self, num_obj: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat = PoseRefineNetFeat(dtype)
        self.head_r = RefineHead(4, num_obj, dtype, (1.0, 0.0, 0.0, 0.0))
        self.head_t = RefineHead(3, num_obj, dtype, (0.0, 0.0, 0.0))

    def forward(self, cloud, emb, obj_idx):
        feat = self.feat(cloud, emb)
        return self.head_r(feat, obj_idx), self.head_t(feat, obj_idx)
