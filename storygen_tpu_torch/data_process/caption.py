"""Narrative captions of a story's frames. Counterpart of
storygen_tpu/data_process/caption.py.

A caption model is a callable `caption_model(image, prompt_text) -> str`;
each frame is captioned with the captions of the frames before it as
context, and the captions are written as <stem>.txt files (the
Text/Caption layout). `hf_captioner` adapts a local HuggingFace
image-to-text checkpoint folder (BLIP-style) on a device.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

CAPTION_INSTRUCTION = (
    "You are given a frame of an illustrated story and, as context, the "
    "captions of the previous frames. Describe this frame in at most 50 "
    "words, keeping names and visual style consistent with the context."
)


def build_prompt(previous_captions: Sequence[str],
                 instruction: str = CAPTION_INSTRUCTION,
                 max_context: int = 3) -> str:
    ctx = previous_captions[-max_context:]
    lines = [instruction]
    if ctx:
        lines.append("Context:")
        lines.extend(f"- {c}" for c in ctx)
    return "\n".join(lines)


def caption_story(frame_paths: Sequence[str], caption_model: Callable,
                  out_dir: Optional[str] = None,
                  max_context: int = 3) -> List[str]:
    """Caption frames sequentially, feeding previous captions as context;
    optionally write <stem>.txt files (the Text/Caption layout)."""
    from PIL import Image
    captions: List[str] = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for p in frame_paths:
        img = Image.open(p).convert("RGB")
        prompt = build_prompt(captions, max_context=max_context)
        cap = caption_model(img, prompt).strip()
        captions.append(cap)
        if out_dir:
            stem = os.path.splitext(os.path.basename(p))[0]
            with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
                f.write(cap)
    return captions


def hf_captioner(checkpoint_dir: str, max_new_tokens: int = 60,
                 device=None) -> Callable:
    """Adapter for a local HuggingFace image-to-text checkpoint folder
    (BLIP-style conditional generation: processor + model) on `device`
    (None: the card). `transformers` is imported here, by the caller that
    needs it.

    Returns `caption_model(image, prompt_text) -> str` for caption_story.
    """
    import torch
    from transformers import AutoProcessor

    from storygen_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    processor = AutoProcessor.from_pretrained(checkpoint_dir)
    model = _load_vision2seq(checkpoint_dir).to(device).eval()

    def fn(image, prompt: str) -> str:
        # BLIP conditions on a short text prefix; long narrative prompts
        # are truncated by the processor's tokenizer limits.
        inputs = processor(images=image, text=prompt,
                           return_tensors="pt", truncation=True,
                           max_length=512).to(device)
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens)
        text = processor.batch_decode(out, skip_special_tokens=True)[0]
        # strip the echoed prompt prefix if the model returns it
        return text[len(prompt):].strip() if text.startswith(prompt) \
            else text.strip()

    return fn


def _load_vision2seq(checkpoint_dir: str):
    from transformers import AutoConfig
    cfg = AutoConfig.from_pretrained(checkpoint_dir)
    arch = (cfg.architectures or [""])[0]
    import transformers
    cls = getattr(transformers, arch, None)
    if cls is None:
        from transformers import AutoModelForVision2Seq
        return AutoModelForVision2Seq.from_pretrained(checkpoint_dir)
    return cls.from_pretrained(checkpoint_dir)
