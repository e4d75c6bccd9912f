"""CLI application skeleton.

Re-implements the reference's application framework
(ref: src/Core/Application.* — config load, channel setup, usage/help,
run() dispatch). Every tool subclasses :class:`Application`; invocation
is ``python -m rasr_tpu.tools.<tool> --config=file --a.b.c=value ...``
with full RASR selector-override semantics.
"""

from __future__ import annotations

import sys
import traceback
from typing import List, Optional, Sequence

from ..utils.compile_cache import enable_compile_cache
from ..utils.component import Component, ParameterString
from ..utils.config import Configuration
from ..utils.logging import LogManager


class Application(Component):
    name: str = "application"
    description: str = ""

    log_file = ParameterString("log-file", default="", doc="JSONL log target")

    def __init__(self, config: Configuration):
        super().__init__(config, self.name)
        if self.log_file:
            LogManager.get().open_jsonl(self.log_file)
            self.log("system-information", **self._system_information())

    @staticmethod
    def _system_information():
        """Host/runtime facts logged at startup (ref: the reference's
        <system-information> element in every XML log)."""
        import os
        import platform

        info = {
            "hostname": platform.node(),
            "python": platform.python_version(),
            "pid": os.getpid(),
            "machine": platform.machine(),
        }
        try:  # devices only if jax is already initialized elsewhere
            import jax

            info["jax"] = jax.__version__
        except Exception:  # pragma: no cover
            pass
        return info

    def run(self, args: List[str]) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @classmethod
    def declared_parameters(cls):
        """(name, default-with-choices, doc) for every declared typed
        parameter, in declaration order (ref: the reference prints its
        Core::Parameter registry in usage/help output)."""
        from ..utils.component import Parameter

        out, seen = [], set()
        for klass in reversed(cls.__mro__):
            for attr, val in vars(klass).items():
                if isinstance(val, Parameter) and val.name not in seen:
                    seen.add(val.name)
                    default = val.default
                    choices = getattr(val, "choices", None)
                    if choices:
                        default = f"{default} ∈ {{{', '.join(map(str, choices))}}}"
                    out.append((val.name, default, val.doc))
        return out

    @classmethod
    def main(cls, argv: Optional[Sequence[str]] = None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--help" in argv or "-h" in argv:
            print(f"{cls.name}: {cls.description}")
            print(f"usage: python -m rasr_tpu.tools.{cls.name.replace('-', '_')} "
                  f"[--config=FILE] [--selector.param=value ...]")
            for pname, default, doc in cls.declared_parameters():
                d = f" (default: {default!r})" if default not in (None, "") else ""
                print(f"  --{cls.name}.{pname}{d}{'  ' + doc if doc else ''}")
            return 0
        enable_compile_cache()
        config = Configuration()
        rest = config.parse_args(argv)
        if "--dump-config" in rest:
            # resolved-configuration dump channel (ref: the reference's
            # config dump: every rule with its source, for debugging
            # selector precedence)
            rest.remove("--dump-config")
            print(config.dump())
        app = cls(config)
        try:
            rc = app.run(rest)
        except Exception as exc:
            app.error(f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            return 1
        # unknown-parameter detection (ref: Core::Configuration usage
        # checking): a mistyped selector/param never gets looked up, so
        # it would otherwise be silently inert
        for rule in config.unused_rules():
            app.warning(
                f"unknown/unused parameter: {'.'.join(rule.pattern)} = "
                f"{rule.value} ({rule.source})"
            )
        return rc
