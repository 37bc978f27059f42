"""Gradio web demo (counterpart of wanq_tpu/cli/gradio_demo.py; the
reference ships four near-identical scripts under gradio/, one per task;
here --task selects the surface):

    python -m wanq_tpu_torch.cli.gradio_demo --task t2v-1.3B --ckpt_dir ...
    python -m wanq_tpu_torch.cli.gradio_demo --task i2v-14B --size 1280*720 ...

:class:`DemoRuntime` is the callback's core (prompt -> umT5 -> denoise ->
VAE decode -> file) and needs no gradio; :func:`build_demo` adds the
gr.Blocks wiring and raises SystemExit where gradio is not installed.
Everything runs on --device, the card unless told otherwise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wanq_tpu_torch.cli.common import add_common_args, check_device, load_params, setup_logging
from wanq_tpu_torch.configs import MAX_AREA_CONFIGS, SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.utils.metrics import as_tensor


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch gradio demo")
    add_common_args(p)
    p.add_argument("--server_port", type=int, default=7860)
    p.add_argument("--prompt_extend", choices=["none", "local", "dashscope"], default="none")
    return p.parse_args(argv)


class DemoRuntime:
    """What the demo's callback needs, built without gradio. ``encoder``,
    ``vae`` and ``clip`` stay None without --ckpt_dir (tests put stand-ins
    there)."""

    def __init__(self, args):
        from wanq_tpu_torch.utils.prompt_extend import (
            DashScopePromptExpander,
            IdentityPromptExpander,
            LocalPromptExpander,
        )

        check_device(args.device)
        self.args = args
        self.cfg = cfg = WAN_CONFIGS[args.task]
        self.device = args.device
        self.is_i2v = cfg.model_type == "i2v"
        self.is_t2i = args.task.startswith("t2i")
        params = load_params(args, cfg)
        self.expander = {
            "none": IdentityPromptExpander,
            "local": lambda: LocalPromptExpander(device=args.device),
            "dashscope": DashScopePromptExpander,
        }[args.prompt_extend]()

        self.encoder = self.vae = self.clip = None
        if args.ckpt_dir:
            from wanq_tpu_torch.models.t5 import T5EncoderModel
            from wanq_tpu_torch.models.vae import WanVAE

            self.encoder = T5EncoderModel(
                cfg.text_len, checkpoint_path=os.path.join(args.ckpt_dir, cfg.t5_checkpoint),
                tokenizer_path=cfg.t5_tokenizer, device=args.device)
            self.vae = WanVAE(vae_pth=os.path.join(args.ckpt_dir, cfg.vae_checkpoint),
                              compute_dtype=getattr(torch, args.vae_dtype), device=args.device)
            if self.is_i2v:
                from wanq_tpu_torch.models.clip import CLIPModel

                self.clip = CLIPModel(checkpoint_path=os.path.join(
                    args.ckpt_dir, cfg.clip_checkpoint), device=args.device)

        if self.is_i2v:
            from wanq_tpu_torch.pipelines.image2video import WanI2V

            self.pipe = WanI2V(cfg, params, device=args.device, vae=self.vae, clip=self.clip)
        else:
            from wanq_tpu_torch.pipelines.text2video import WanT2V

            self.pipe = WanT2V(cfg, params, device=args.device)

    def run(self, prompt, image, steps, guide_scale, shift, seed, extend,
            error_cls=RuntimeError, out_path="gradio_out.mp4"):
        """The Generate button: one generate and decode. Returns
        (video_path, image_array, final_prompt), the demo's three outputs;
        ``error_cls`` is gr.Error under gradio."""
        from wanq_tpu_torch.utils.video import cache_video

        args, cfg, dev = self.args, self.cfg, self.device
        if extend:
            prompt = self.expander(prompt, tar_lang="en").prompt
        if self.encoder is None:
            raise error_cls("no --ckpt_dir: demo needs the T5 checkpoint")
        ctx = as_tensor(self.encoder([prompt])).to(dev)
        ctx_null = as_tensor(self.encoder([args.neg_prompt])).to(dev)
        common = dict(frame_num=1 if self.is_t2i else args.frame_num,
                      sampling_steps=int(steps), guide_scale=float(guide_scale),
                      shift=float(shift), seed=int(seed))
        if self.is_i2v:
            if image is None:
                raise error_cls("i2v needs an input image")
            img = np.asarray(image, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
            img = torch.from_numpy(img).to(dev)
            latents = self.pipe.generate(img, ctx, ctx_null, max_area=MAX_AREA_CONFIGS[args.size],
                                         **common)
        else:
            latents = self.pipe.generate(ctx, ctx_null, size=SIZE_CONFIGS[args.size], **common)
        video = as_tensor(self.vae.decode(latents)).cpu().numpy()
        if self.is_t2i:
            frame = video[0, :, 0]  # [3, H, W] in [-1, 1]
            img_out = ((frame.transpose(1, 2, 0) + 1.0) * 127.5).clip(0, 255)
            return None, img_out.astype(np.uint8), prompt
        return cache_video(video, out_path, fps=cfg.sample_fps), None, prompt


def build_demo(args):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit("gradio is not installed; the demo wraps the pipeline API that "
                         "wanq_tpu_torch.cli.generate uses") from e

    setup_logging()
    rt = DemoRuntime(args)

    def run(prompt, image, steps, guide_scale, shift, seed, extend):
        return rt.run(prompt, image, steps, guide_scale, shift, seed, extend,
                      error_cls=gr.Error)

    with gr.Blocks(title=f"wanq_tpu_torch {args.task}") as demo:
        gr.Markdown(f"## Wan2.1 {args.task} (PyTorch / CUDA)")
        with gr.Row():
            prompt = gr.Textbox(label="Prompt", lines=3)
            image = gr.Image(label="Input image", visible=rt.is_i2v)
        with gr.Row():
            steps = gr.Slider(1, 100, value=args.sample_steps, label="Steps")
            gs = gr.Slider(1, 15, value=args.sample_guide_scale, label="Guidance")
            shift = gr.Slider(1, 10, value=args.sample_shift, label="Shift")
            seed = gr.Number(value=args.base_seed, label="Seed")
            extend = gr.Checkbox(label="Extend prompt")
        btn = gr.Button("Generate")
        video = gr.Video(label="Output video", visible=not rt.is_t2i)
        image_out = gr.Image(label="Output image", visible=rt.is_t2i)
        final_prompt = gr.Textbox(label="Final prompt", interactive=False)
        btn.click(run, [prompt, image, steps, gs, shift, seed, extend],
                  [video, image_out, final_prompt])
    return demo


def main():
    args = parse_args()
    demo = build_demo(args)
    demo.launch(server_name="0.0.0.0", server_port=args.server_port)


if __name__ == "__main__":
    main()
