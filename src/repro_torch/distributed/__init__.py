from .sharding import (BASE_RULES, FSDP_RULES, SP_RULES, flatten,
                       gather_weight, linear, named_shardings, pinned,
                       placements,
                       replicate_like, resolve_spec, rules_with, set_rules,
                       shard, specs_for_tree, unflatten, unsharded, use_mesh,
                       use_rules)

__all__ = ["BASE_RULES", "SP_RULES", "FSDP_RULES", "rules_with", "set_rules",
           "use_rules", "shard", "resolve_spec", "specs_for_tree",
           "named_shardings", "use_mesh", "placements", "replicate_like",
           "gather_weight", "unflatten", "flatten", "unsharded", "linear",
           "pinned"]
