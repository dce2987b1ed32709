from spark_rapids_tpu_torch.regex.transpiler import (  # noqa: F401
    CompiledRegex,
    RegexUnsupported,
    compile_search,
)
