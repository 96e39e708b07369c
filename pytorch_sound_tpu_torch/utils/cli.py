"""Minimal `fire`-style CLI dispatch: the port's copy of
``pytorch_sound_tpu/utils/cli.py``, same argv-to-kwargs conversions.

``fire_like(fn)`` maps ``prog arg1 arg2 --key=value`` onto a function call;
``fire_like(Cls)`` maps ``prog method arg1 --key=value`` onto
``Cls().method(...)``, as ``fire.Fire(main)`` / ``fire.Fire(Processor)`` do.
"""

import inspect
import sys
from typing import Any, Callable, List, Optional


def _convert(value: str, annotation) -> Any:
    """Best-effort string -> annotated/primitive type conversion."""
    if annotation in (int,):
        return int(value)
    if annotation in (float,):
        return float(value)
    if annotation in (bool,):
        return value.lower() in ('1', 'true', 'yes', 'y')
    if annotation in (str,) or annotation is inspect.Parameter.empty:
        # untyped: try int, float, bool literals, else string
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        if value.lower() in ('true', 'false'):
            return value.lower() == 'true'
        return value
    try:
        return annotation(value)
    except Exception:
        return value


def _call_with_argv(fn: Callable, argv: List[str]) -> Any:
    if any(tok in ('-h', '--help') for tok in argv):
        doc = inspect.getdoc(fn)
        print('usage: {}{}'.format(getattr(fn, '__name__', 'command'),
                                   str(inspect.signature(fn))))
        if doc:
            print(doc)
        return None
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    positional: List[Any] = []
    kwargs = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith('--'):
            key = tok[2:]
            if '=' in key:
                key, val = key.split('=', 1)
            else:
                i += 1
                val = argv[i] if i < len(argv) else 'true'
            key = key.replace('-', '_')
            ann = sig.parameters[key].annotation if key in sig.parameters \
                else inspect.Parameter.empty
            kwargs[key] = _convert(val, ann)
        else:
            idx = len(positional)
            ann = params[idx].annotation if idx < len(params) \
                else inspect.Parameter.empty
            positional.append(_convert(tok, ann))
        i += 1
    return fn(*positional, **kwargs)


def fire_like(target, argv: Optional[List[str]] = None) -> Any:
    """Dispatch CLI args onto a function, or onto methods of a class/instance."""
    argv = list(sys.argv[1:] if argv is None else argv)

    if inspect.isfunction(target) or inspect.ismethod(target):
        return _call_with_argv(target, argv)

    obj = target() if inspect.isclass(target) else target
    methods = {name: m for name, m in inspect.getmembers(
                   obj, lambda m: inspect.ismethod(m) or inspect.isfunction(m))
               if not name.startswith('_')}
    if not argv or argv[0] in ('-h', '--help'):
        print('usage: {} <command> [args...]'.format(sys.argv[0]))
        print('commands:')
        for name in sorted(methods):
            print('  {}{}'.format(name, str(inspect.signature(methods[name]))))
        return None
    command = argv[0]
    if command not in methods:
        raise SystemExit('unknown command {!r}; available: {}'.format(
            command, ', '.join(sorted(methods))))
    return _call_with_argv(methods[command], argv[1:])
