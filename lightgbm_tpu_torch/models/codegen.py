"""Model -> standalone C++ if-else code.

The JAX package's ``models/codegen.py``, copied: the reference
convert_model task (src/boosting/gbdt_model_text.cpp:56-238
SaveModelToIfElse, src/io/tree.cpp Tree::ToIfElse). Emits one
``PredictTreeN`` function per tree as nested if-else over raw feature
values plus a ``PredictRaw`` driver, compilable without any framework
dependency; the text is the JAX package's, byte for byte (its header
line too).
"""
from __future__ import annotations

from typing import List

from ..io.binning import MissingType
from .tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree


def _node_to_if_else(t: Tree, index: int, indent: str) -> List[str]:
    if index < 0:
        return [f"{indent}return {t.leaf_value[~index]!r};"]
    dt = t.decision_type[index]
    feat = t.split_feature[index]
    lines: List[str] = []
    if dt & K_CATEGORICAL_MASK:
        ci = t.threshold_in_bin[index]
        lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
        words = ", ".join(f"{t.cat_threshold[w]}u" for w in range(lo, hi))
        lines.append(f"{indent}{{ static const uint32_t bits[] = {{{words}}};")
        lines.append(
            f"{indent}  int cat = static_cast<int>(arr[{feat}]);")
        lines.append(
            f"{indent}  if (cat >= 0 && cat < {32 * (hi - lo)} && "
            f"((bits[cat / 32] >> (cat % 32)) & 1)) {{")
        lines.extend(_node_to_if_else(t, t.left_child[index],
                                      indent + "    "))
        lines.append(f"{indent}  }} else {{")
        lines.extend(_node_to_if_else(t, t.right_child[index],
                                      indent + "    "))
        lines.append(f"{indent}  }}")
        lines.append(f"{indent}}}")
        return lines
    mtype = (dt >> 2) & 3
    default_left = bool(dt & K_DEFAULT_LEFT_MASK)
    thr = t.threshold[index]
    cond = f"arr[{feat}] <= {thr!r}"
    if mtype == MissingType.NAN:
        miss = f"std::isnan(arr[{feat}])"
        cond = (f"({miss} || {cond})" if default_left
                else f"(!{miss} && {cond})")
    elif mtype == MissingType.ZERO:
        miss = f"(arr[{feat}] >= -1e-35 && arr[{feat}] <= 1e-35)"
        cond = (f"({miss} || {cond})" if default_left
                else f"(!{miss} && {cond})")
    lines.append(f"{indent}if ({cond}) {{")
    lines.extend(_node_to_if_else(t, t.left_child[index], indent + "  "))
    lines.append(f"{indent}}} else {{")
    lines.extend(_node_to_if_else(t, t.right_child[index], indent + "  "))
    lines.append(f"{indent}}}")
    return lines


def tree_to_if_else(t: Tree, tree_idx: int) -> str:
    """Tree::ToIfElse (src/io/tree.cpp)."""
    body: List[str] = [
        f"double PredictTree{tree_idx}(const double* arr) {{"]
    if t.num_leaves == 1:
        body.append(f"  return {t.leaf_value[0]!r};")
    else:
        body.extend(_node_to_if_else(t, 0, "  "))
    body.append("}")
    return "\n".join(body)


def model_to_if_else(gbdt) -> str:
    """GBDT::SaveModelToIfElse (gbdt_model_text.cpp:56-238)."""
    gbdt._ensure_host_trees()
    models = gbdt.models
    k = max(gbdt.num_tree_per_iteration, 1)
    parts = [
        "// Generated by lightgbm_tpu convert_model",
        "#include <cmath>",
        "#include <cstdint>",
        "#include <vector>",
        "",
        "namespace LightGBM {",
        "",
    ]
    for i, t in enumerate(models):
        parts.append(tree_to_if_else(t, i))
        parts.append("")
    parts.append(
        "void PredictRaw(const double* arr, double* output) {")
    for cls in range(k):
        cls_calls = " + ".join(
            f"PredictTree{i}(arr)"
            for i in range(cls, len(models), k)) or "0.0"
        parts.append(f"  output[{cls}] = {cls_calls};")
    parts.append("}")
    parts.append("")
    parts.append("}  // namespace LightGBM")
    return "\n".join(parts) + "\n"
