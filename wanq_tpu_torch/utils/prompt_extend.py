"""Prompt extension: rewrite a terse user prompt into a detailed one
before it is encoded (counterpart of wanq_tpu/utils/prompt_extend.py; the
reference's wan/utils/prompt_extend.py).

The expanders are side services, not the port's compute:
  * DashScopePromptExpander: the DashScope API (needs the dashscope
    package and a key; raises ImportError without the package);
  * LocalPromptExpander: any Hugging Face causal LM through transformers,
    on ``device`` (the card unless the caller asks for the CPU);
  * LocalVLPromptExpander: a local Qwen2.5-VL (or compatible) model that
    also sees the i2v input image (utils/vision.py prepares it);
  * IdentityPromptExpander: returns the prompt as it is.
transformers and dashscope are imported when an expander is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# system prompts (published in the reference, prompt_extend.py:112-155)
LM_EN_SYS_PROMPT = (
    "You are a prompt engineer specializing in text-to-video generation. "
    "Rewrite the user's prompt into a detailed, vivid description of the "
    "scene: subjects, their appearance and motion, the environment, "
    "lighting, camera movement and style. Keep the original intent, output "
    "only the rewritten prompt."
)
LM_ZH_SYS_PROMPT = (
    "你是一位文生视频提示词工程师。请将用户的提示词改写为细节丰富的场景描述："
    "主体及其外观与动作、环境、光照、镜头运动与风格。保持原意，只输出改写后的提示词。"
)
VL_EN_SYS_PROMPT = (
    "You are a prompt engineer for image-to-video generation. Given an "
    "input image and the user's prompt, describe the scene in vivid detail "
    "— the subjects as they appear in the image, their likely motion, the "
    "environment, lighting, camera movement and style. Stay faithful to "
    "the image content, keep the user's intent, output only the rewritten "
    "prompt."
)
VL_ZH_SYS_PROMPT = (
    "你是一位图生视频提示词工程师。根据输入图像和用户提示词，生成细节丰富的场景描述："
    "忠实于图像中的主体与环境，补充其可能的动作、光照、镜头运动与风格。"
    "保持用户原意，只输出改写后的提示词。"
)


@dataclasses.dataclass
class PromptOutput:
    status: bool
    prompt: str
    seed: int = -1
    system_prompt: str = ""
    message: str = ""


class PromptExpander:
    def __init__(self, model_name: Optional[str] = None, is_vl: bool = False):
        self.model_name = model_name
        self.is_vl = is_vl

    def decide_system_prompt(self, tar_lang: str = "en") -> str:
        if self.is_vl:
            return VL_ZH_SYS_PROMPT if tar_lang == "zh" else VL_EN_SYS_PROMPT
        return LM_ZH_SYS_PROMPT if tar_lang == "zh" else LM_EN_SYS_PROMPT

    def __call__(self, prompt: str, tar_lang: str = "en", seed: int = -1,
                 image=None, **kwargs) -> PromptOutput:
        sys_prompt = self.decide_system_prompt(tar_lang)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, sys_prompt, image=image,
                                        seed=seed, **kwargs)
        return self.extend(prompt, sys_prompt, seed=seed, **kwargs)

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        raise NotImplementedError

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        **kwargs) -> PromptOutput:
        raise NotImplementedError


class IdentityPromptExpander(PromptExpander):
    """No-op expander (prompt extension disabled)."""

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        return PromptOutput(True, prompt, seed, system_prompt)


class DashScopePromptExpander(PromptExpander):
    """ref DashScopePromptExpander: qwen-plus via the DashScope API."""

    def __init__(self, api_key: Optional[str] = None,
                 model_name: str = "qwen-plus", retry_times: int = 4):
        super().__init__(model_name)
        self.retry_times = retry_times
        try:
            import dashscope

            if api_key:
                dashscope.api_key = api_key
            self._ds = dashscope
        except ImportError as e:
            raise ImportError(
                "DashScopePromptExpander needs the 'dashscope' package"
            ) from e

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        last = ""
        for _ in range(self.retry_times):
            resp = self._ds.Generation.call(
                self.model_name, messages=messages, seed=max(seed, 0),
                result_format="message",
            )
            if resp.status_code == 200:
                out = resp.output.choices[0].message.content
                return PromptOutput(True, out, seed, system_prompt)
            last = str(resp)
        return PromptOutput(False, prompt, seed, system_prompt, message=last)


class LocalPromptExpander(PromptExpander):
    """The reference's QwenPromptExpander, generalized: any Hugging Face
    causal LM, on ``device``; ``hf_kwargs`` go to ``from_pretrained``."""

    def __init__(self, model_name: str = "Qwen/Qwen2.5-3B-Instruct", device="cuda",
                 **hf_kwargs):
        super().__init__(model_name)
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.device = device
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModelForCausalLM.from_pretrained(model_name, **hf_kwargs).to(device)

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        text = self.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
        inputs = self.tokenizer([text], return_tensors="pt").to(self.device)
        out = self.model.generate(**inputs, max_new_tokens=512)
        out = out[:, inputs.input_ids.shape[1]:]
        expanded = self.tokenizer.batch_decode(out, skip_special_tokens=True)[0]
        return PromptOutput(True, expanded, seed, system_prompt)


class LocalVLPromptExpander(PromptExpander):
    """ref QwenPromptExpander in VL mode (prompt_extend.py Qwen-VL branch):
    a local Qwen2.5-VL (or compatible) HF vision-language model rewrites
    the prompt conditioned on the i2v input image, on ``device``. The image
    is prepared by utils/vision.py::process_vision_info."""

    def __init__(self, model_name: str = "Qwen/Qwen2.5-VL-3B-Instruct", device="cuda",
                 **hf_kwargs):
        super().__init__(model_name, is_vl=True)
        from transformers import AutoModelForVision2Seq, AutoProcessor

        self.device = device
        self.processor = AutoProcessor.from_pretrained(model_name)
        self.model = AutoModelForVision2Seq.from_pretrained(
            model_name, **hf_kwargs).to(device)

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        **kwargs) -> PromptOutput:
        from wanq_tpu_torch.utils.vision import process_vision_info

        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": prompt},
            ]},
        ]
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        images, videos = process_vision_info(messages)
        inputs = self.processor(text=[text], images=images, videos=videos,
                                return_tensors="pt").to(self.device)
        out = self.model.generate(**inputs, max_new_tokens=512)
        out = out[:, inputs.input_ids.shape[1]:]
        expanded = self.processor.batch_decode(
            out, skip_special_tokens=True)[0]
        return PromptOutput(True, expanded, seed, system_prompt)
