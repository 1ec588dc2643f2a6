"""Conversation templates (LLaVA lineage).

A copy of `setok_tpu/data/conversation.py`: `Conversation` with the five
separator styles (`get_prompt`) and the 16-entry registry `conv_templates`
(vicuna v0/v1, llama_2, llava_{v0,v1,llama_2}, mpt, plain/v0_plain,
v0/v1_mmtag, mistral_instruct, chatml/mistral_direct, the default
aliases), as the reference SeTok code's `src/conversation.py` has them.
Left out, as there: the base64-image serving helpers and the tuple-image
first message, which only the reference's Gradio demo uses.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
        elif self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
        elif self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
        elif self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            ret = ret.lstrip(self.sep)
        elif self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
        else:
            raise ValueError(f"Invalid style: {self.sep_style}")
        return ret

    def append_message(self, role: str, message: str) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=[[r, m] for r, m in self.messages],
                            offset=self.offset, sep_style=self.sep_style,
                            sep=self.sep, sep2=self.sep2,
                            version=self.version)


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0")

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1")

conv_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. You are able "
           "to understand the visual content that the user provides, and "
           "assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
    version="llama_v2")

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an LLM-"
           "based AI assistant. The assistant gives helpful and honest "
           "answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[],
    offset=0, sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")

conv_llava_plain = Conversation(
    system="", roles=("", ""), messages=[], offset=0,
    sep_style=SeparatorStyle.PLAIN, sep="\n", version="plain")

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.SINGLE, sep="###")

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1")

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. You are able "
           "to understand the visual content that the user provides, and "
           "assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
    version="llama_v2")

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant is able to understand the visual "
           "content that the user provides, and assist the user with a "
           "variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("Human", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag")

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant is able to understand the visual "
           "content that the user provides, and assist the user with a "
           "variety of tasks using natural language."
           "The visual content will be provided with the following format: "
           "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
    version="v1_mmtag")

conv_mistral_instruct = Conversation(
    system="", roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA_2, sep="", sep2="</s>",
    version="llama_v2")

conv_chatml_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[],
    offset=0, sep_style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")

default_conversation = conv_vicuna_v1

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
