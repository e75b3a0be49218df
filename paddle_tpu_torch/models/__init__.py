from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,
                   BertModel)
from .generation import generate
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel)
from .unet import UNet2DConditionModel, UNetConfig

__all__ = ["LlamaConfig", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "GPTConfig", "GPTModel",
           "GPTForCausalLM", "BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "UNetConfig",
           "UNet2DConditionModel", "generate"]
