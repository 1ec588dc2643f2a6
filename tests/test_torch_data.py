"""The port's conversations, multimodal tokenization, preprocessing and
collator against the JAX package's, on the CPU. Every comparison is exact:
both packages run the same Python over the same tokenizers.

  * `Conversation.get_prompt` of every entry of `conv_templates`;
  * `tokenizer_image_token` / `tokenizer_target_token` on prompts with 0,
    1 and 2 sentinels, `expand_image_slots`, `pad_or_truncate`,
    `get_model_name_from_path`, `KeywordsStoppingCriteria` (also inside
    the port's `ServeEngine`);
  * `preprocess_multimodal` and `preprocess` in its four dialects (plain,
    v1, llama_2, mpt), with `WordTokenizer` and with a byte-level BPE
    `tokenizer.json` that the test trains with `tokenizers` and loads
    through `load_text_tokenizer` (the assistant-span masking depends on
    tokenized lengths, which a word tokenizer cannot show off by one);
  * `Collator`'s arrays and passthrough keys.
"""

import copy

import numpy as np
import pytest
import torch

import setok_tpu.data.collator as jcollator
import setok_tpu.data.conversation as jconv
import setok_tpu.data.mm_tokens as jmm
import setok_tpu.data.preprocess as jpre
import setok_tpu.data.tokenizer as jtok
from setok_tpu_torch import config as cfgs
from setok_tpu_torch import constants
from setok_tpu_torch.data import collator, conversation, mm_tokens, preprocess
from setok_tpu_torch.data.tokenizer import WordTokenizer, load_text_tokenizer
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.utils.init import init_setokim_random_
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

IGNORE = constants.IGNORE_INDEX
BPE_TEXT = [
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.",
    "USER: What is in the picture? ASSISTANT: A red cat on a mat.</s>",
    "[INST] <<SYS>> You are a helpful language and vision assistant. "
    "<</SYS>> Describe it. [/INST] A dog runs over green grass.",
    "<|im_start|>system conversation between a user and an LLM-based AI "
    "assistant <|im_end|><|im_start|>user <|im_start|>assistant",
    "Describe the image. What does this picture show? Here you go.",
]


def write_bpe_tokenizer(path, texts=BPE_TEXT, vocab: int = 400) -> str:
    """A byte-level BPE trained on `texts` (BOS prepended; `<s>`, `</s>`,
    `<unk>` and `<pad>` special), saved as an HF tokenizer directory."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            processors, trainers)
    from transformers import PreTrainedTokenizerFast
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(texts, trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=["<unk>", "<s>", "</s>", "<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        unk_token="<unk>", pad_token="<pad>").save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    return write_bpe_tokenizer(tmp_path_factory.mktemp("bpe"))


@pytest.fixture(scope="module", params=["word", "bpe"])
def tokenizers(request, bpe_dir):
    """(port tokenizer, JAX tokenizer): the word-hash one, or the BPE
    loaded by each package's `load_text_tokenizer`."""
    if request.param == "word":
        return WordTokenizer(512), jtok.WordTokenizer(512)
    return load_text_tokenizer(bpe_dir), jtok.load_text_tokenizer(bpe_dir)


def test_constants_are_the_jax_packages():
    import setok_tpu.constants as jconst
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) == 9
    for n in names:
        assert getattr(constants, n) == getattr(jconst, n), n


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_every_template_prompts_as_jax(name):
    assert sorted(conversation.conv_templates) == sorted(jconv.conv_templates)
    got = conversation.conv_templates[name].copy()
    want = jconv.conv_templates[name].copy()
    assert got.sep_style.name == want.sep_style.name
    for conv in (got, want):
        r = conv.roles
        for role, msg in ((r[0], "<image>\nWhat is this?"),
                          (r[1], "A cat on a mat."),
                          (r[0], "And its colour?"), (r[1], None)):
            conv.append_message(role, msg)
    assert got.get_prompt() == want.get_prompt()
    assert conversation.default_conversation.version == \
        jconv.default_conversation.version


PROMPTS = ["Describe the picture in detail.",
           "<image>\nWhat is shown here?",
           "First <image> and then <image> again, compare them.",
           "Make it blue <target> please",
           "<target> <target> twice"]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_sentinel_tokenization_as_jax(prompt, tokenizers):
    tok, jt = tokenizers
    for fn, jfn in ((mm_tokens.tokenizer_image_token,
                     jmm.tokenizer_image_token),
                    (mm_tokens.tokenizer_target_token,
                     jmm.tokenizer_target_token)):
        got = fn(prompt, tok)
        assert got == jfn(prompt, jt)
    n_img = prompt.count("<image>")
    ids = mm_tokens.tokenizer_image_token(prompt, tok)
    assert ids.count(constants.IMAGE_TOKEN_INDEX) == n_img
    assert ids[0] == tok.bos_token_id and ids.count(tok.bos_token_id) == 1


def test_slots_padding_and_model_names():
    ids = [1, 5, constants.IMAGE_TOKEN_INDEX, 7, constants.IMAGE_TOKEN_INDEX]
    labels = [IGNORE, 5, IGNORE, 7, IGNORE]
    assert mm_tokens.expand_image_slots(ids, 3) == \
        jmm.expand_image_slots(ids, 3)
    assert mm_tokens.expand_image_slots(ids, 3, labels) == \
        jmm.expand_image_slots(ids, 3, labels)
    for n in (3, 5, 9):
        got = mm_tokens.pad_or_truncate(ids, n, -1)
        np.testing.assert_array_equal(got, jmm.pad_or_truncate(ids, n, -1))
        assert got.dtype == np.int64
    for path in ("org/llava-7b", "/ckpt/run/checkpoint-200/",
                 "vicuna-7b-v1.5"):
        assert mm_tokens.get_model_name_from_path(path) == \
            jmm.get_model_name_from_path(path)


@pytest.mark.parametrize("keywords", [["</s>"], ["stop here", "###"]])
def test_keyword_stopping_as_jax(keywords, tokenizers):
    tok, jt = tokenizers
    got = mm_tokens.KeywordsStoppingCriteria(keywords, tok)
    want = jmm.KeywordsStoppingCriteria(keywords, jt)
    assert got.keyword_ids == want.keyword_ids
    tail = [i for kw in got.keyword_ids for i in kw]
    for out in ([1, 20, 30], [1, 20, *tail], [1, *got.keyword_ids[-1]]):
        assert got.should_stop(out) == want.should_stop(out)


def test_keyword_stopping_in_the_engine():
    """The port's engine stops a request where the JAX criterion first says
    stop over its greedy stream."""
    model = init_setokim_random_(Setokim(cfgs.tiny_setokim(), device="cpu"),
                                 0)
    prompt = np.concatenate([[1], np.arange(10, 16)])

    def run(stopping=None):
        eng = ServeEngine(model, max_batch=1, prompt_len=16, max_len=32,
                          eos_id=-1)
        req = eng.submit(prompt, max_new_tokens=12, stopping=stopping)
        eng.run()
        return req.tokens

    free = run()
    tok = WordTokenizer(cfgs.tiny_setokim().llama.vocab_size)
    # a word whose hash is the stream's fourth token
    word = next(w for w in (f"w{i}" for i in range(100000))
                if tok.encode(w)[1:] == [free[3]])
    jtk = jtok.WordTokenizer(tok.vocab_size)
    want = jmm.KeywordsStoppingCriteria([word], jtk)
    first = next(k for k in range(1, len(free) + 1)
                 if want.should_stop(free[:k]))
    got = run(mm_tokens.KeywordsStoppingCriteria([word], tok))
    assert got == free[:first] and len(got) <= 4


def conversations(has_image: bool):
    img = "<image>\n" if has_image else ""
    return [
        [{"from": "human", "value": img + "What is in the picture?"},
         {"from": "gpt", "value": "A red cat on a mat."}],
        [{"from": "human", "value": img + "Describe it."},
         {"from": "gpt", "value": "A dog runs over green grass."},
         {"from": "human", "value": "And the sky?"},
         {"from": "gpt", "value": "Blue, with a few clouds."}],
        # starts with the assistant: the first turn is dropped
        [{"from": "gpt", "value": "Hello."},
         {"from": "human", "value": img + "Caption this."},
         {"from": "gpt", "value": "A boat on a river."}],
    ]


@pytest.mark.parametrize("start_end", [False, True])
def test_preprocess_multimodal_as_jax(start_end):
    src = [[{"from": "human", "value": "look <image> here"},
            {"from": "gpt", "value": "<target>\nDone."}]]
    got = preprocess.preprocess_multimodal(
        copy.deepcopy(src), mm_use_im_start_end=start_end, target_num=3)
    want = jpre.preprocess_multimodal(
        copy.deepcopy(src), mm_use_im_start_end=start_end, target_num=3)
    assert got == want
    assert got[0][1]["value"].count("<target>") == 3
    assert preprocess.preprocess_multimodal(
        copy.deepcopy(src), is_multimodal=False) == src


@pytest.mark.parametrize("version,has_image", [
    ("plain", True), ("v1", True), ("v1", False), ("llama_2", True),
    ("llama_2", False), ("mpt", True), ("mpt", False)])
def test_preprocess_dialects_as_jax(version, has_image, tokenizers):
    """(The plain dialect is `<image>` + caption: it always has an
    image.)"""
    tok, jt = tokenizers
    sources = ([s[:2] for s in conversations(True)[:2]] if version == "plain"
               else conversations(has_image))
    got = preprocess.preprocess(copy.deepcopy(sources), tok,
                                has_image=has_image, version=version)
    want = jpre.preprocess(copy.deepcopy(sources), jt, has_image=has_image,
                           version=version)
    assert got == want
    # the masking kept some answers supervised
    assert any(v != IGNORE for lbl in got["labels"] for v in lbl)
    for ids, lbl in zip(got["input_ids"], got["labels"]):
        assert len(ids) == len(lbl)
        assert all(v in (IGNORE, i) for v, i in zip(lbl, ids))


def test_preprocess_rejects_an_unknown_role():
    bad = [[{"from": "human", "value": "hi"}, {"from": "human", "value": "x"}]]
    with pytest.raises(AssertionError, match="roles mismatch"):
        preprocess.preprocess(bad, WordTokenizer(512), version="v1")


def instances(rs, n: int, with_images: bool = True):
    out = []
    for i in range(n):
        ids = [1, *rs.randint(10, 400, 3 + i).tolist(),
               constants.IMAGE_TOKEN_INDEX, *rs.randint(10, 400, 4).tolist()]
        inst = {"input_ids": ids,
                "labels": [IGNORE] * 3 + ids[3:],
                "input_ids_for_contrastive": rs.randint(10, 400, 5 + i),
                "caption": f"caption {i}"}
        if with_images:
            inst["comp_image"] = rs.rand(8, 8, 3)
            inst["gen_image"] = rs.rand(8, 8, 3) * 2 - 1
        out.append(inst)
    return out


@pytest.mark.parametrize("max_len,k_max,expand", [(24, 4, True),
                                                  (10, 4, True),
                                                  (16, 2, False)])
def test_collator_as_jax(max_len, k_max, expand):
    insts = instances(np.random.RandomState(3), 3, with_images=max_len > 10)
    got = collator.Collator(max_len=max_len, k_max=k_max,
                            expand_images=expand)(copy.deepcopy(insts))
    want = jcollator.Collator(max_len=max_len, k_max=k_max,
                              expand_images=expand)(copy.deepcopy(insts))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k
    assert got["input_ids"].shape == (3, max_len)
    assert torch.from_numpy(got["attention_mask"]).dtype == torch.bool
