"""The CLIP text encoder, SD2's OpenCLIP-H text tower (counterpart of
``lkgd_tpu/models/clip_text.py``), under transformers' ``CLIPTextModel`` names
(``text_model.embeddings.token_embedding``, ``text_model.encoder.layers.N.self_attn.q_proj``,
``text_model.final_layer_norm``). A causal transformer over BPE token ids: the layers are
the vision tower's (``clip_vision.CLIPEncoderLayer``, exact-erf GELU) with a causal mask.
``output_hidden_state_index=-2`` runs one layer fewer (SD2's penultimate-layer convention);
the final LayerNorm is applied either way, as in the JAX module. Its 77 tokens run the
plain attention.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from lkgd_torch.models.clip_vision import CLIPEncoder
from lkgd_torch.models.configs import CLIPTextConfig, CLIPVisionConfig


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def init_extra(self, generator: torch.Generator) -> None:
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.weight.normal_(0.0, 0.02, generator=generator)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        layer_cfg = CLIPVisionConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                                     intermediate_size=cfg.intermediate_size,
                                     num_layers=cfg.num_layers, hidden_act=cfg.hidden_act,
                                     layer_norm_eps=cfg.layer_norm_eps)
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(layer_cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor, output_hidden_state_index: int = -1
                ) -> torch.Tensor:
        """(B, L) token ids -> (B, L, D) hidden states after ``final_layer_norm``; -1 runs
        every layer, -2 all but the last."""
        tm, cfg = self.text_model, self.config
        l = input_ids.shape[1]
        emb = tm.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[None, :l]
        causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()[None, None]
        n_run = cfg.num_layers if output_hidden_state_index == -1 else (
            cfg.num_layers + 1 + output_hidden_state_index)
        for layer in tm.encoder.layers[:n_run]:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
