"""The reference's training step: plain PyTorch, eager, float32 with TF32
off unless the caller asks for the control.  The step of the port's
``train/trainer.py`` written out plainly: pixel gather, render, IDR loss,
the gradient clipped to a global norm of 1.0 as ``optax.clip_by_global_norm``
does (no epsilon), and ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8,
the learning rate a float); a step whose gradient is not finite takes no
update.  It imports nothing of the port."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .loss import IDRLossConfig, idr_loss
from .renderer import IDRNetwork
from .support import Config

MAX_GRAD_NORM = 1.0
# the forward's per-ray outputs that the comparison reads of the first step
RAY_OUTPUTS = ("rgb_values", "sdf_output", "points", "network_object_mask", "object_mask")
BETAS = (0.9, 0.999)
EPS = 1e-8


def make_weights(model_conf: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights of the configuration, drawn on ``device`` from
    ``seed`` by the model's own init (geometric sphere init of the SDF MLP,
    the encoders' and the rendering MLP's inits)."""
    model = IDRNetwork(Config(model_conf), device=device, seed=seed)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def make_draws(model: IDRNetwork, generator: torch.Generator, n_rays: int
               ) -> Dict[str, torch.Tensor]:
    """The uniform draws of one training forward over ``n_rays`` rays."""
    return model.draw_uniforms(generator, n_rays, generator.device)


def rgb_to_pm1(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32 (rend_util.py:8-16)."""
    return (rgb_uint8.to(torch.float32) / 255.0 - 0.5) * 2.0


def loss_terms(model: IDRNetwork, loss_cfg: IDRLossConfig, scene: Dict[str, torch.Tensor],
               img_idx: torch.Tensor, pixel_idx: torch.Tensor, alpha: float,
               draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gather the step's pixels, render them and return the loss terms."""
    B = img_idx.shape[0]
    inputs = {
        "uv": scene["uv"][pixel_idx][None].expand(B, -1, -1),
        "intrinsics": scene["intrinsics"][img_idx],
        "pose": scene["pose"][img_idx],
        "object_mask": scene["mask"][img_idx][:, pixel_idx],
    }
    rgb_gt = rgb_to_pm1(scene["rgb"][img_idx][:, pixel_idx])
    outputs = model(inputs, training=True, draws=draws)
    return idr_loss(loss_cfg, outputs, rgb_gt, alpha)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    if g_norm >= max_norm:
        for g in grads:
            g.copy_((g / g_norm) * max_norm)
    return g_norm


def loss_config(conf: Dict) -> IDRLossConfig:
    lc = conf["loss"]
    return IDRLossConfig(eikonal_weight=lc["eikonal_weight"], mask_weight=lc["mask_weight"],
                         alpha=lc["alpha"], tv_weight=float(lc.get("tv_weight", 0.0)))


def run_steps(conf: Dict, scene: Dict[str, torch.Tensor], weights: Dict[str, torch.Tensor],
              steps: List[Dict], tf32: bool = False, keep_rays: Optional[int] = None,
              guide_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Train ``len(steps)`` steps from ``weights`` on the inputs of the
    program's first steps (each a dict of ``img_idx``, ``pixel_idx``,
    ``alpha``, ``draws``, ``lr``).  Returns each step's loss terms, the
    first step's clipped gradient by parameter name and the parameters
    after the last step, and the first step's per-ray outputs
    (``RAY_OUTPUTS``).  ``tf32=True`` runs the products in TF32 (the
    control), ``guide_dtype`` the fused guidance's weight and operand type
    (bf16 as configured; a control lowers it); each step's gradient norms by leaf come with them
    (``grad_norms``); ``keep_rays`` trains on the first that many rays of each step
    and their share of the eikonal samples (a fault: part of the batch left
    out, the mean taken over the rest)."""
    if conf["loss"].get("tv_weight", 0.0):
        raise ValueError("the reference step has no total-variation term")
    device = scene["uv"].device
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = IDRNetwork(Config(conf["model"]), device=device, seed=0)
        model.load_state_dict(weights)
        model.implicit_network.guide_dtype = guide_dtype
        rays1: Dict[str, torch.Tensor] = {}

        def keep_outputs(module, args, out):
            if not rays1:
                rays1.update({k: out[k].detach().clone() for k in RAY_OUTPUTS})

        model.register_forward_hook(keep_outputs)
        names = {p: n for n, p in model.named_parameters()}
        params = list(model.parameters())
        opt = torch.optim.Adam(params, lr=float(steps[0]["lr"]), betas=BETAS, eps=EPS)
        cfg = loss_config(conf)
        losses, grad1, grad_norms = [], {}, []
        for k, inp in enumerate(steps):
            pixel_idx, draws = inp["pixel_idx"], dict(inp["draws"])
            if keep_rays is not None:
                pixel_idx = pixel_idx[:keep_rays]
                draws["eik"] = draws["eik"][: keep_rays // 2]
            for g in opt.param_groups:
                g["lr"] = float(inp["lr"])
            opt.zero_grad(set_to_none=True)
            terms = loss_terms(model, cfg, scene, inp["img_idx"], pixel_idx, inp["alpha"], draws)
            terms["loss"].backward()
            g_norm = clip_by_global_norm(params, MAX_GRAD_NORM)
            if k == 0:
                grad1 = {names[p]: p.grad.detach().clone() for p in params if p.grad is not None}
            grad_norms.append({names[p]: float(torch.linalg.vector_norm(p.grad.double()))
                               for p in params if p.grad is not None})
            if torch.isfinite(g_norm):
                opt.step()
            losses.append({n: float(v.detach()) for n, v in terms.items()})
        after = {n: p.detach().clone() for n, p in model.named_parameters()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"losses": losses, "grad1": grad1, "grad_norms": grad_norms, "params": after,
            "rays1": rays1}
