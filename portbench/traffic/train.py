"""Traffic of kind ``train``: a closed loop of the program's DM train step
(``DMTrainer.train_step``) on batches already on the card.

The mix file gives ``batch`` (clips a step, each the configuration's
cond + pred frames), ``pool`` (batches made in set-up and cycled: every
batch of the first ``pool`` steps is new) and ``check_block`` (rows the
reference runs at once). Each batch comes with its diffusion times and
noise, all from the seed, and goes through the same call in set-up and in
the window. Set-up builds one trainer, with the configuration's AdamW
schedule, and drives it through the first three steps, which also warm
it up; the window continues the same trainer.

The check has two parts. The start: the plain float32 reference follows
the same three steps from the same weights, clips, times and noise (its
gradient summed over blocks of rows, which the mean loss allows: no row
reads another). It reads each step's loss, each parameter's gradient norm
of the first step as the program's AdamW holds it after that step (its
first moment over 1 - beta1), and each parameter's change over the three
steps, read before the fourth. A timed step: one step of the window,
drawn from the seed among its first ``WINDOW_STEPS``, is taken again by
the reference from the program's own state before it (its parameters,
AdamW moments and update count, kept on the card during the window);
the reference reads that step's loss and each parameter's change. The
cell's limits name the numbers compared. A norm's gap is measured against
the larger of the reference's norm of that parameter and the median
parameter's; parameters whose reference gradient lies under a thousandth
of the median one's move by rounding alone and are left out of the
change.
"""
from __future__ import annotations

import contextlib
import random
import time

import torch

from portbench import program, weights
from portbench.cost.flops import train_flops
from portbench.harness import Run, Window
from portbench.reference.pipeline import adamw_update, multi_step_lr

CHECKED = 3  # steps the reference follows from the start
WINDOW_STEPS = 16  # the timed step the reference takes again is one of the window's first
BETA1 = 0.9
CLIPS, TIMES, NOISE = 5_000_000, 6_000_000, 7_000_000  # generator streams of a step's inputs
SLEEPING = 1e-3  # a parameter's gradient under this share of the median one's: left out


def batch(run: Run, k: int):
    """Step k's clips (B, tc + tp, H, W, 3), diffusion times (B,) and noise."""
    m, B = run.config["model"], run.traffic["batch"]
    tc, tp, px, h = m["cond_frames"], m["pred_frames"], m["frame_shape"], program.latent_size(m)
    video = weights.clips(run.seed, CLIPS + k, B, tc + tp, px, run.device)
    t = torch.randint(0, m["timesteps"], (B,), generator=weights.generator(run.seed, TIMES + k,
                                                                           run.device),
                      device=run.device)
    noise = torch.randn((B, tp, h, h, 3), generator=weights.generator(run.seed, NOISE + k,
                                                                      run.device),
                        device=run.device)
    return video, t, noise


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


def prepare(run: Run) -> dict:
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    tr = run.config["train"]
    fd = program.build(run)
    opt = make_optimizer(fd.unet.parameters(), tr["lr"], tr["milestones"], tr["gamma"],
                         tr["weight_decay"])
    trainer = DMTrainer(fd, opt)
    pool = [batch(run, k) for k in range(max(run.traffic["pool"], CHECKED))]
    names, params = zip(*fd.unet.named_parameters())
    start = [p.detach().clone() for p in params]
    losses = []
    for k in range(CHECKED):
        video, t, noise = pool[k]
        losses.append(trainer.train_step(None, video, t=t, noise=noise)["loss"].detach())
        if k == 0:  # the first gradient as AdamW holds it (nothing, if it took no step)
            grad = leaf_norms(opt.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                              for p in params)
    change = leaf_norms(p.detach() - p0 for p, p0 in zip(params, start))
    del start
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return dict(fd=fd, trainer=trainer, pool=pool, checked_step=window_step(run), readings=dict(
        names=names, loss=torch.stack(losses).float().cpu(), grad=grad.cpu(),
        change=change.cpu()))


def window_step(run: Run) -> int:
    """The window step that the reference takes again, drawn from the seed."""
    return random.Random(run.seed + 2).randrange(WINDOW_STEPS)


def snapshot(opt) -> dict:
    """The optimizer's parameters, AdamW moments and counts, copied (a
    parameter that AdamW has not stepped has zero moments)."""
    params = [p.detach() for p in opt.params]
    state = [opt.opt.state[p] for p in opt.params]
    moment = lambda key: torch._foreach_mul(  # noqa: E731
        [s.get(key, torch.zeros_like(p)) for s, p in zip(state, params)], 1.0)
    step = state[0].get("step", torch.zeros(()))
    return dict(params=torch._foreach_mul(params, 1.0), m=moment("exp_avg"),
                v=moment("exp_avg_sq"), step=torch.as_tensor(step).clone(), count=opt.count)


def step_change(opt, before: dict) -> torch.Tensor:
    """Each parameter's change since `before`, as a norm."""
    return torch.stack(torch._foreach_norm(
        torch._foreach_sub([p.detach() for p in opt.params], before["params"])))


def spans(state: dict, spans) -> None:
    lfae = state["fd"].lfae
    spans.layer(lfae, "encode_video", "encode_video")
    spans.layer(lfae, "ref_features", "ref_features")


def measure(run: Run, state: dict) -> Window:
    """The closed loop; it runs at least as far as the checked step."""
    trainer, pool, sync = state["trainer"], state["pool"], run.device.type == "cuda"
    m, checked = run.config["model"], state["checked_step"]
    k, last = 0, 0.0
    start = time.perf_counter()
    while k <= checked or time.perf_counter() - start < run.seconds:
        video, t, noise = pool[(CHECKED + k) % len(pool)]
        if k == checked:
            before = snapshot(trainer.optimizer)
        aux = trainer.train_step(None, video, t=t, noise=noise)
        if k == checked:
            state["window"] = dict(step=CHECKED + k, before=before, loss=aux["loss"].detach(),
                                   change=step_change(trainer.optimizer, before))
        if sync:
            torch.cuda.synchronize(run.device)
        last = time.perf_counter()
        k += 1
    elapsed = last - start
    frames = k * run.traffic["batch"] * (m["cond_frames"] + m["pred_frames"])
    return Window(units=k, elapsed_s=elapsed,
                  rates={"train_frames_per_s": frames / elapsed}, attempted=k, failed=0)


def release(state: dict) -> None:
    for key in ("fd", "trainer"):
        state.pop(key, None)


def reference_grad(run: Run, ref, params, inputs, product_mode=None, rows=None):
    """The reference's loss of one step's batch and its parameters'
    gradients, summed over blocks of rows. `product_mode` (a dispatch mode)
    computes its products in another precision; `rows` takes only those
    rows of the batch (a fault)."""
    video, t, noise = inputs
    if rows is not None:
        video, t, noise = video[rows], t[rows], noise[rows]
    B, block = video.shape[0], run.traffic["check_block"]
    for p in params:
        p.grad = None
    total = torch.zeros((), device=run.device)
    with product_mode if product_mode is not None else contextlib.nullcontext():
        for a in range(0, B, block):
            part = slice(a, a + block)
            loss = ref.loss(video[part], t[part], noise[part]) * (video[part].shape[0] / B)
            loss.backward()
            total += loss.detach()
    return total, [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def reference_model(run: Run):
    ref = weights.reference(run.config["model"], run.seed, run.device)
    ref.lfae.requires_grad_(False)
    names, params = zip(*ref.unet.named_parameters())
    return ref, names, params


def reference_steps(run: Run, pool, product_mode=None, rows=None) -> dict:
    """The reference's readings of the first steps: losses, the first
    gradient's and the updates' norm per parameter (`product_mode`, `rows`:
    as ``reference_grad``)."""
    tr = run.config["train"]
    ref, names, params = reference_model(run)
    start = [p.detach().clone() for p in params]
    moments = [None] * len(params)
    losses, grad = [], None
    for k in range(CHECKED):
        loss, grads = reference_grad(run, ref, params, pool[k], product_mode, rows)
        losses.append(loss)
        if k == 0:
            grad = leaf_norms(grads)
        lr = multi_step_lr(tr["lr"], tr["milestones"], tr["gamma"], k)
        adamw_update(params, grads, moments, k + 1, lr, tr["weight_decay"])
    change = leaf_norms(p.detach() - p0 for p, p0 in zip(params, start))
    return dict(names=names, loss=torch.stack(losses).cpu(), grad=grad.cpu(),
                change=change.cpu())


def reference_window(run: Run, state: dict, product_mode=None, rows=None) -> dict:
    """The reference's readings of the checked window step, taken from the
    program's state before it: the step's loss, its gradient's and the
    update's norm per parameter (`product_mode`, `rows`: as
    ``reference_grad``)."""
    tr, window = run.config["train"], state["window"]
    before, order = window["before"], state["readings"]["names"]
    ref, names, params = reference_model(run)
    index = [order.index(n) for n in names]
    with torch.no_grad():
        for p, i in zip(params, index):
            p.copy_(before["params"][i])
    moments = [(before["m"][i], before["v"][i]) for i in index]
    start = [p.detach().clone() for p in params]
    inputs = state["pool"][window["step"] % len(state["pool"])]
    loss, grads = reference_grad(run, ref, params, inputs, product_mode, rows)
    lr = multi_step_lr(tr["lr"], tr["milestones"], tr["gamma"], before["count"])
    adamw_update(params, grads, moments, int(before["step"].item()) + 1, lr, tr["weight_decay"])
    change = leaf_norms(p.detach() - p0 for p, p0 in zip(params, start))
    return dict(names=names, loss=loss.reshape(1).cpu(), grad=leaf_norms(grads).cpu(),
                change=change.cpu())


def window_readings(state: dict) -> dict:
    """The program's readings of the checked window step."""
    window = state["window"]
    return dict(names=state["readings"]["names"], loss=window["loss"].float().reshape(1).cpu(),
                change=window["change"].cpu())


def _gaps(a, b, keep=None):
    d = (a - b).abs() / torch.clamp(b, min=b.median().item())
    return d if keep is None else d[keep]


def _in_order(got: dict, want: dict, keys) -> dict:
    order = [want["names"].index(n) for n in got["names"]]
    return dict(want, **{k: want[k][order] for k in keys})


def _loss_rel(got: dict, want: dict) -> float:
    return ((got["loss"] - want["loss"]).abs() / want["loss"].abs()).max().item()


def compare(got: dict, want: dict) -> dict:
    """The start: the worst step's relative loss gap; per parameter, the gap
    of its first gradient's norm and of its change's norm, each against the
    larger of the reference's norm of that parameter and the median
    parameter's, taken by the worst parameter (``*_norm_gap``) and by the
    median one (``*_median_gap``). Parameters that sleep in the reference
    are left out of the change."""
    want = _in_order(got, want, ("grad", "change"))
    keep = want["grad"] >= SLEEPING * want["grad"].median()
    grad, change = _gaps(got["grad"], want["grad"]), _gaps(got["change"], want["change"], keep)
    return {"loss_rel": _loss_rel(got, want),
            "grad_norm_gap": grad.max().item(), "grad_median_gap": grad.median().item(),
            "update_norm_gap": change.max().item(), "update_median_gap": change.median().item()}


def compare_window(got: dict, want: dict) -> dict:
    """The checked window step: its relative loss gap and its change's gap
    per parameter, as ``compare`` reads them."""
    want = _in_order(got, want, ("grad", "change"))
    keep = want["grad"] >= SLEEPING * want["grad"].median()
    change = _gaps(got["change"], want["change"], keep)
    return {"window_loss_rel": _loss_rel(got, want),
            "window_update_norm_gap": change.max().item(),
            "window_update_median_gap": change.median().item()}


def check(run: Run, state: dict) -> dict:
    return {**compare(state["readings"], reference_steps(run, state["pool"])),
            **compare_window(window_readings(state), reference_window(run, state))}


def unit_flops(run: Run) -> float:
    return train_flops(run.config["model"], run.traffic["batch"])
