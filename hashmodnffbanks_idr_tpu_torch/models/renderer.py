"""IDRNetwork: the full differentiable render pass.

Counterpart of ``hashmodnffbanks_idr_tpu/models/renderer.py``
(impl..._renderer.py:225-329 of the reference): the tracer runs without
gradient on the current parameters (the ``tracer`` span; what follows is
the ``render`` span, ``utils/profiling.py``); the SDF is re-evaluated with
gradient at the found points; one batched spatial gradient over
``[detached points, eikonal samples]`` gives both the detached surface
normals for the sample network and the eikonal term; misses render white.

Tracer precision (``model.tracer_fast``; JAX :49-74):
  'exact' -- everything float32; with ``model.tracer_exact_fused = true``
             the tracer's SDF queries go through the fused float32 kernel;
             level-pruned guidance (``prune_*``) runs float32 too;
  'mixed' -- bf16 guidance (march phase A, sweep coarse probes, the first
             ``prune_secant_iters`` secant steps) through the fused bf16
             kernel, float32 decisions through the fused float32 kernel
             where it launches (``fused_mlp.kernel_takes``: the network's
             parameters on a CUDA device, the architecture it is built
             for), else the float32 layer chain (``sdf``);
  'fast'  -- every tracer query through the fused bf16 kernel.
Elsewhere the fused path is chosen from the config alone: ``fused_sdf_raw``
launches the CUDA kernel for a CUDA tensor and runs its plain twin for a
CPU one.
``tracer_exact_fused`` is read from the conf only.  The JAX package also
takes its default from the ``HMNFFB_EXACT_FUSED`` environment variable
(JAX :72-74); the port ignores that variable, so a run is reproduced from
its ``runconf.conf`` alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..config.hocon import Config
from ..geometry.cameras import get_camera_params
from ..ops import fused_mlp as fm
from ..utils.profiling import span
from .networks import ImplicitNetwork, RenderingNetwork
from .ray_tracing import RayTracerConfig, ray_trace, sweep_draws
from .sample_network import sample_network


class IDRNetwork(nn.Module):
    def __init__(self, conf: Config, device=None, seed: int = 0):
        """Builds the model from the ``model`` conf block with random weights
        drawn from ``seed``, on ``device`` (None -> the CUDA card)."""
        super().__init__()
        device = resolve_device(device)
        self.feature_vector_size = conf.get_int("feature_vector_size")
        implicit_kwargs = dict(conf.get_config("implicit_network").data)
        emb = conf.get_config("embedding_network", None)
        if emb is not None:
            implicit_kwargs.update(emb.data)  # impl..._renderer.py:229-233
        self.implicit_network = ImplicitNetwork(self.feature_vector_size, **implicit_kwargs)
        self.rendering_network = RenderingNetwork(
            self.feature_vector_size, **conf.get_config("rendering_network").data)
        self.ray_tracer = RayTracerConfig(**conf.get_config("ray_tracer").data)
        self.object_bounding_sphere = conf.get_float("ray_tracer.object_bounding_sphere")
        tf = conf.get("tracer_fast", "exact")
        self.tracer_mode = {True: "fast", False: "exact"}.get(tf, tf)
        if self.tracer_mode not in ("fast", "mixed", "exact"):
            raise ValueError(f"tracer_fast={tf!r}")
        self.tracer_exact_fused = bool(conf.get("tracer_exact_fused", False))

        gen = torch.Generator().manual_seed(seed)
        self.implicit_network.reset_parameters(gen)
        self.rendering_network.reset_parameters(gen)
        self.to(device)

    def _tracer_sdfs(self):
        """(decision SDF, guidance dict or None) for the tracer mode
        (JAX :106-163).  Guidance is level-pruned where the conf's
        ``prune_levels_*`` ask for it and the encoder supports it: bf16
        (the bf16 kernel) in 'mixed' and 'fast', f32 in 'exact' (the f32
        kernel with ``tracer_exact_fused``); with ``prune_secant_iters`` the
        first secant iterations run on the coarse (else march) guide.  The
        mixed tracer's float32 decisions take the f32 kernel wherever it
        launches (``fm.kernel_takes``), the layer chain elsewhere."""
        net, rt = self.implicit_network, self.ray_tracer

        def fast(max_level=None, floor=False):
            return net.make_fast_sdf("bf16", max_level=max_level, floor_interp=floor)

        def pruned_f32(max_level, floor):
            return net.make_fast_sdf("f32", max_level=max_level, floor_interp=floor,
                                     fused=self.tracer_exact_fused)

        def build_guidance(make_base=None, precision="bf16"):
            """march/coarse guides: level-pruned SDFs where the conf and the
            encoder allow them, else ``make_base()``; each SDF built once."""
            make = fast if precision == "bf16" else pruned_f32
            prune = ((rt.prune_levels_march > 0 or rt.prune_levels_coarse > 0)
                     and net.supports_level_pruning())
            fns, guide = {}, {}
            for key, k in (("march", rt.prune_levels_march), ("coarse", rt.prune_levels_coarse)):
                k = k if prune else 0
                if k > 0 or make_base is not None:
                    if k not in fns:
                        fns[k] = make(k, rt.prune_floor_interp) if k > 0 else make_base()
                    guide[key] = fns[k]
            if guide and rt.prune_secant_iters > 0:
                guide["secant"] = guide.get("coarse") or guide.get("march")
            return guide or None

        if self.tracer_mode == "exact":
            sdf = net.make_fast_sdf("f32") if self.tracer_exact_fused else net.sdf
            return sdf, build_guidance(precision="f32")
        if self.tracer_mode == "fast":
            return fast(), build_guidance()
        on_kernel = fm.kernel_takes(net.dims, net.skip_in, net.lin[0].b.device)
        decide = net.make_fast_sdf("f32") if on_kernel else net.sdf
        return decide, build_guidance(make_base=fast)

    def has_coarse_guide(self) -> bool:
        """Whether ``_tracer_sdfs``'s guidance has a ``'coarse'`` SDF (which
        sets the sweep's stride), from the conf alone: the mixed tracer's
        bf16 base guide, or a level-pruned coarse guide."""
        rt = self.ray_tracer
        prune = ((rt.prune_levels_march > 0 or rt.prune_levels_coarse > 0)
                 and self.implicit_network.supports_level_pruning())
        return self.tracer_mode == "mixed" or (prune and rt.prune_levels_coarse > 0)

    def draw_uniforms(self, generator: Optional[torch.Generator], n_rays: int,
                      device) -> Dict[str, torch.Tensor]:
        """The uniform draws a training forward over ``n_rays`` rays on
        ``device`` takes from ``generator`` (``_draws``): the tracer's sweep
        and the eikonal samples ``'eik'``.  A sharded step draws the global
        ones on every rank and hands each rank its rows of ``'eik'``; the
        graphed step draws them before its replays."""
        like = torch.empty((), dtype=torch.float32, device=device)
        return self._draws(generator, n_rays, self.has_coarse_guide(), like, training=True)

    def _draws(self, generator, n_rays, coarse_guide, like, training):
        """What the forward draws when none are injected, in the order it
        takes them: the sweep's (``ray_tracing.sweep_draws``, whose stride
        follows ``coarse_guide``), then in training the eikonal samples,
        (n_rays // 2, 3) in [-r, r] (impl..._renderer.py:276-284)."""
        draws = sweep_draws(self.ray_tracer, coarse_guide, generator, like)
        if training:
            bb = self.object_bounding_sphere
            u = torch.rand((n_rays // 2, 3), generator=generator, dtype=like.dtype,
                           device=like.device)
            draws["eik"] = -bb + u * (2 * bb)
        return draws

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, training: bool = True,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``draws`` may inject every uniform draw of the forward (see
        ``_draws``); without it they come from ``generator``."""
        object_mask = inputs["object_mask"].reshape(-1).to(torch.bool)
        pose = inputs["pose"]

        with torch.no_grad(), span("tracer"):
            ray_dirs, cam_loc = get_camera_params(inputs["uv"], pose, inputs["intrinsics"])
            B, P, _ = ray_dirs.shape
            R = B * P
            sdf, guidance = self._tracer_sdfs()
            if draws is None:
                draws = self._draws(generator, R, bool(guidance and "coarse" in guidance),
                                    cam_loc, training)
            trace = ray_trace(self.ray_tracer, sdf, cam_loc, object_mask, ray_dirs,
                              generator=generator, training=training,
                              sdf_guidance=guidance, draws=draws)
        with span("render"):
            if pose.requires_grad:
                # trainable cameras: the differentiable rays (the same values) are
                # built after the tracer, so that the graphed step's autograd graph
                # starts past the tracer's loops
                ray_dirs, cam_loc = get_camera_params(inputs["uv"], pose, inputs["intrinsics"])
            network_object_mask = trace.network_object_mask
            dists = trace.dists

            cam_flat = cam_loc[:, None, :].expand(B, P, 3).reshape(R, 3)
            dirs_flat = ray_dirs.reshape(R, 3)
            points = cam_flat + dists[:, None] * dirs_flat

            sdf_output = self.implicit_network(points)[:, 0:1]

            grad_theta = None
            if training:
                surface_mask = network_object_mask & object_mask
                eik_points = torch.as_tensor(draws["eik"], dtype=points.dtype,
                                             device=points.device)
                g = self.implicit_network.gradient(torch.cat([points.detach(), eik_points],
                                                             dim=0))
                surface_points_grad = g[:R].detach()
                grad_theta = torch.cat([g[R:], g[:R]], dim=0)
                differentiable_points = sample_network(
                    sdf_output, sdf_output.detach(), surface_points_grad, dists[:, None],
                    cam_flat, dirs_flat, valid_mask=surface_mask)
            else:
                surface_mask = network_object_mask
                differentiable_points = points

            rgb_raw = self._get_rgb_value(differentiable_points, -dirs_flat)
            rgb_values = torch.where(surface_mask[:, None], rgb_raw, torch.ones_like(rgb_raw))

            out = {
                "points": points,
                "rgb_values": rgb_values,
                "sdf_output": sdf_output,
                "network_object_mask": network_object_mask,
                "object_mask": object_mask,
                "dists": dists,
            }
            if training:
                out["grad_theta"] = grad_theta
            return out

    def _get_rgb_value(self, points, view_dirs):
        """Normals from the SDF gradient feed the appearance net with the
        feature vector (impl..._renderer.py:321-329)."""
        output = self.implicit_network(points)
        normals = self.implicit_network.gradient(points)
        return self.rendering_network(points, normals, view_dirs, output[:, 1:])
