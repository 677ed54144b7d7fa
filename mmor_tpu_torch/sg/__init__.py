"""Scene-graph text engine: vocabulary, triplet parsing, temporal memory, prompts.

Copy of ``mmor_tpu/sg/__init__.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Pure-Python (host-side) logic shared by the MM2SG data pipeline, the training
JSON generators and the evaluation harness.
"""

from mmor_tpu_torch.sg.vocab import (
    ENTITIES,
    PREDICATES,
    VOCAB,
    entity_id,
    name_from_vocab_id,
    normalize_role,
    vocab_id,
)
from mmor_tpu_torch.sg.converters import (
    collapse_sgs,
    find_related_entities,
    parse_sg_string,
    sg_history_to_change_log,
    change_log_to_memory_str,
    triplets_to_sg_string,
)
from mmor_tpu_torch.sg.prompts import (
    IMAGE_TOKEN,
    IMAGE_TOKEN_INDEX,
    IGNORE_INDEX,
    SG_PROMPT,
    VicunaConversation,
    build_sg_prompt,
    tokenize_with_image_token,
)

__all__ = [
    "ENTITIES",
    "PREDICATES",
    "VOCAB",
    "entity_id",
    "name_from_vocab_id",
    "normalize_role",
    "vocab_id",
    "collapse_sgs",
    "find_related_entities",
    "parse_sg_string",
    "sg_history_to_change_log",
    "change_log_to_memory_str",
    "triplets_to_sg_string",
    "IMAGE_TOKEN",
    "IMAGE_TOKEN_INDEX",
    "IGNORE_INDEX",
    "SG_PROMPT",
    "VicunaConversation",
    "build_sg_prompt",
    "tokenize_with_image_token",
]
