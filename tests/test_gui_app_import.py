"""Import smoke test for the wx view layer with a stubbed wx module.

wxPython is absent in CI; a minimal stand-in lets the module body (palette
construction, class definitions, schema wiring) execute so name errors and
schema drift are caught without a display.
"""
import sys
import types

import pytest


class _WxStub(types.ModuleType):
    def __getattr__(self, name):
        if name.isupper():          # flag / id constants
            return 1
        if name[0].isupper():       # widget classes
            return type(name, (), {
                "__init__": lambda self, *a, **k: None,
            })
        raise AttributeError(name)


@pytest.fixture()
def stubbed_wx(monkeypatch):
    stub = _WxStub("wx")
    monkeypatch.setitem(sys.modules, "wx", stub)
    sys.modules.pop("describealign_jax.gui.app", None)
    yield stub
    sys.modules.pop("describealign_jax.gui.app", None)


def test_app_module_imports_and_wires_schema(stubbed_wx):
    from describealign_jax.gui import app
    # palette has both modes with all severity colors
    for mode in (True, False):
        assert {"bg", "fg", "accent", "warn", "err"} <= set(
            app.PALETTE[mode])
    # view classes exist and build on the headless core
    for cls in ("MainFrame", "CombineFrame", "SettingsDialog",
                "MediaListBox"):
        assert hasattr(app, cls)
    assert callable(app.run_gui)


def test_is_dark_defaults_false_without_backend(stubbed_wx):
    from describealign_jax.gui import app
    assert app._is_dark() is False
