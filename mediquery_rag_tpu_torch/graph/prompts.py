# Copy of mediquery_rag_tpu/graph/prompts.py (the port imports nothing of the JAX package).
"""Prompts for the Self-RAG graph nodes. Original text, written for the
same jobs the reference's inline prompts do (grade / rewrite / generate /
best-effort; nodes.py:152-207, core/utils.py:49-87)."""

GRADE_PROMPT = """你是一个检索质量评审员。判断下面的资料是否有助于回答用户的问题。
只输出一个词：yes 或 no。

用户问题：{question}

资料：
{documents}

是否相关（yes/no）："""

REWRITE_PROMPT = """用户的问题在知识库中没有检索到足够相关的资料。
请把问题改写成更适合检索的形式：保留关键医学术语，去掉口语化表达，突出核心概念。
只输出改写后的问题，不要解释。

原问题：{question}"""

GENERATE_PROMPT = """你是一位专业、谨慎的健康科普助手。请根据提供的资料回答用户的问题。

要求：
- 优先基于【参考资料】作答；资料不足的部分可以用常识补充，但要注明。
- 回答使用中文，条理清晰，避免诊断性结论，必要时建议就医。
{profile_section}
【参考资料】（来源：{source_tag}）
{documents}

【用户问题】
{question}

回答："""

PROFILE_SECTION = """- 结合【用户健康档案】给出个性化建议，并注意档案中的重要事项。

【用户健康档案】
{profile}
"""

BEST_EFFORT_PROMPT = """你是一位健康科普助手。知识库和网络检索都没有找到足够相关的资料。
请基于医学常识谨慎回答用户的问题，明确说明信息有限，并建议咨询专业医生。

【用户问题】
{question}

回答："""

ASSESSMENT_FALLBACK = (
    "如需进行健康指标计算（如 BMI、基础代谢率、理想体重），"
    "请提供身高（cm）、体重（kg）、年龄和性别。"
)
