"""Headless-testable web editor for DSP workspace configs.

Reference semantics: the PySide6 config editor
(/root/reference/configRoutines/ui/, 959 LoC — window listing sources /
signals / processings / workspaces with typed edit forms and file
save/load). Re-expressed in the same stdlib-HTTP pattern as
viz/webviewer.py so it runs on headless accelerator hosts and is drivable from
tests: a JSON API over ThreadingHTTPServer plus a single-page form UI.

Capabilities (parity with the reference editor's actions):
  * open one or more INI config files; list their typed sections,
  * create / delete sections of each kind (source, signal, processing,
    workspace — names are auto-prefixed src_/sig_/pro_ like the reference's
    DSPConfig.add_* helpers, configRoutines/_core.py:383-413),
  * edit / add / remove keys with per-kind type validation (floats, ints,
    booleans validated before they ever reach the file),
  * every mutation is persisted ATOMICALLY (tempfile + os.replace in the
    config's directory) so a crash mid-save can never truncate a config.

The known-key schemas mirror the typed section proxies in io/config.py
(which mirror the reference SectionProxy subclasses). Unknown keys are
allowed — configs are open dictionaries in the reference too.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..io.config import DSPConfig

# key -> type tag per section kind; mirrors io/config.py typed properties
# (and the reference configRoutines/_core.py:109-233). "str" keys are
# free-form; typed keys are validated on set.
SCHEMAS = {
    "source": {"srcdir": "str", "fs": "float", "fc": "float",
               "conjSamples": "bool", "headerBytes": "int", "dtype": "str",
               "lonlatalt": "lonlatalt"},
    "signal": {"target_fc": "float", "baud": "float", "numPeriodBits": "int",
               "numBurstBits": "int", "numGuardBits": "int",
               "numBursts": "int", "hasChannels": "bool",
               "numChannels": "int", "channelSpacingHz": "float"},
    "processing": {"src": "str", "sig": "str", "numTaps": "int",
                   "target_osr": "int", "threshold": "float"},
    "workspace": {},
}

_KIND_PREFIX = {"source": "src_", "signal": "sig_", "processing": "pro_",
                "workspace": ""}
_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def _kind_of(section: str) -> str:
    if section.startswith("src_"):
        return "source"
    if section.startswith("sig_"):
        return "signal"
    if section.startswith("pro_"):
        return "processing"
    return "workspace"


def _validate(kind: str, key: str, value: str) -> str | None:
    """Return an error string if ``value`` fails the typed schema."""
    tag = SCHEMAS.get(kind, {}).get(key)
    if tag in (None, "str"):
        return None
    try:
        if tag == "float":
            float(value)
        elif tag == "int":
            int(value)
        elif tag == "bool":
            if value.lower() not in ("1", "0", "true", "false", "yes", "no",
                                     "on", "off"):
                raise ValueError(value)
        elif tag == "lonlatalt":
            parts = value.split(",")
            if len(parts) != 3:
                raise ValueError("need lon,lat,alt")
            [float(p) for p in parts]
    except ValueError:
        return f"key {key!r} expects {tag}, got {value!r}"
    return None


class ConfigWebEditor:
    """Edit one or more DSPConfig INI files over a JSON HTTP API."""

    def __init__(self, paths):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        self._lock = threading.Lock()
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)

    # ------------------------------------------------------------ storage
    def _load(self, file_idx: int) -> DSPConfig:
        return DSPConfig(self.paths[int(file_idx)])

    def _save_atomic(self, file_idx: int, cfg: DSPConfig) -> None:
        """Write-to-temp + os.replace: the config file is never observable
        in a half-written state (the reference editor's save is a plain
        overwrite; an interrupted save there truncates the file)."""
        path = self.paths[int(file_idx)]
        dirname = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(prefix=".cfg_", dir=dirname)
        try:
            with os.fdopen(fd, "w") as f:
                cfg.write(f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ---------------------------------------------------------------- api
    def api_files(self):
        return {"files": [{"index": i, "path": p}
                          for i, p in enumerate(self.paths)]}

    def api_schema(self):
        return {"schemas": SCHEMAS}

    def api_config(self, file_idx: int):
        cfg = self._load(file_idx)
        sections = []
        rejected = []
        for name in cfg.sections():
            # validate names on LOAD too, not just on set: a hostile config
            # file must not be able to smuggle markup/script fragments into
            # the page through section/key names (ADVICE round-4)
            if not _NAME_RE.match(name):
                rejected.append(name[:128])
                continue
            keys = {}
            for k, v in cfg[name].items():
                if _NAME_RE.match(k):
                    keys[k] = v
                else:
                    rejected.append(f"{name}/{k[:128]}")
            sections.append({
                "name": name,
                "kind": _kind_of(name),
                "keys": keys,
            })
        out = {"path": self.paths[int(file_idx)], "sections": sections}
        if rejected:
            out["rejected_names"] = rejected
        return out

    def api_set(self, file_idx: int, section: str, key: str, value: str):
        if not _NAME_RE.match(key):
            return {"error": f"invalid key name {key!r}"}, 400
        with self._lock:
            cfg = self._load(file_idx)
            if not cfg.has_section(section):
                return {"error": f"no section {section!r}"}, 404
            err = _validate(_kind_of(section), key, value)
            if err:
                return {"error": err}, 400
            cfg[section][key] = value
            self._save_atomic(file_idx, cfg)
        return {"ok": True}, 200

    def api_delkey(self, file_idx: int, section: str, key: str):
        with self._lock:
            cfg = self._load(file_idx)
            if not cfg.has_section(section):
                return {"error": f"no section {section!r}"}, 404
            if not cfg.remove_option(section, key):
                return {"error": f"no key {key!r}"}, 404
            self._save_atomic(file_idx, cfg)
        return {"ok": True}, 200

    def api_addsection(self, file_idx: int, kind: str, name: str):
        if kind not in _KIND_PREFIX:
            return {"error": f"unknown kind {kind!r}"}, 400
        if not _NAME_RE.match(name):
            return {"error": f"invalid section name {name!r}"}, 400
        full = _KIND_PREFIX[kind] + name
        if kind == "workspace" and _kind_of(full) != "workspace":
            return {"error": "workspace names must not carry a type "
                             "prefix"}, 400
        with self._lock:
            cfg = self._load(file_idx)
            if cfg.has_section(full):
                return {"error": f"section {full!r} exists"}, 409
            cfg.add_section(full)
            self._save_atomic(file_idx, cfg)
        return {"ok": True, "section": full}, 200

    def api_delsection(self, file_idx: int, section: str):
        with self._lock:
            cfg = self._load(file_idx)
            if not cfg.remove_section(section):
                return {"error": f"no section {section!r}"}, 404
            self._save_atomic(file_idx, cfg)
        return {"ok": True}, 200

    # -------------------------------------------------------------- server
    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        editor = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                try:
                    if url.path == "/":
                        body = _PAGE.encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/html; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif url.path == "/api/files":
                        self._json(editor.api_files())
                    elif url.path == "/api/schema":
                        self._json(editor.api_schema())
                    elif url.path == "/api/config":
                        self._json(editor.api_config(int(q["file"])))
                    else:
                        self._json({"error": "not found"}, 404)
                except (KeyError, IndexError, ValueError) as e:
                    self._json({"error": str(e)}, 400)

            def do_POST(self):
                url = urllib.parse.urlsplit(self.path)
                # cross-origin defence (ADVICE round-4): browsers always
                # attach Origin to cross-site POSTs — reject anything not
                # same-origin, and require the JSON content type our own
                # page sends (text/plain "simple request" smuggling fails)
                origin = self.headers.get("Origin")
                if origin is not None:
                    ohost = urllib.parse.urlsplit(origin).netloc
                    if ohost != self.headers.get("Host", ""):
                        self._json({"error": "cross-origin POST rejected"},
                                   403)
                        return
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if ctype.strip().lower() != "application/json":
                    self._json({"error": "Content-Type must be "
                                         "application/json"}, 415)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if url.path == "/api/set":
                        obj, code = editor.api_set(
                            req["file"], req["section"], req["key"],
                            str(req["value"]))
                    elif url.path == "/api/delkey":
                        obj, code = editor.api_delkey(
                            req["file"], req["section"], req["key"])
                    elif url.path == "/api/addsection":
                        obj, code = editor.api_addsection(
                            req["file"], req["kind"], req["name"])
                    elif url.path == "/api/delsection":
                        obj, code = editor.api_delsection(
                            req["file"], req["section"])
                    else:
                        obj, code = {"error": "not found"}, 404
                    self._json(obj, code)
                except (KeyError, IndexError, ValueError,
                        json.JSONDecodeError) as e:
                    self._json({"error": str(e)}, 400)

        return ThreadingHTTPServer((host, port), Handler)

    def serve_background(self, host: str = "127.0.0.1", port: int = 0):
        """Start serving on a daemon thread; returns (server, actual_port)."""
        srv = self.make_server(host, port)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, srv.server_address[1]


# --------------------------------------------------------------------- page
_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>DSP Config Editor</title>
<style>
:root{color-scheme:light;
 --surface:#fcfcfb;--panel:#f2f1ee;--ink:#0b0b0b;--ink2:#52514e;
 --grid:#e4e2dc;--series:#2a78d6;--accent:#eb6834}
@media (prefers-color-scheme: dark){:root{color-scheme:dark;
 --surface:#1a1a19;--panel:#232322;--ink:#ffffff;--ink2:#c3c2b7;
 --grid:#3a3935;--series:#3987e5;--accent:#d95926}}
body{margin:0;font:14px/1.45 system-ui,sans-serif;background:var(--surface);
 color:var(--ink);display:flex;min-height:100vh}
#side{width:280px;min-width:280px;background:var(--panel);padding:12px;
 border-right:1px solid var(--grid)}
#main{flex:1;padding:16px;overflow:auto}
h1{font-size:16px;margin:0 0 10px}
h2{font-size:14px;margin:16px 0 6px;color:var(--ink2)}
.sec{padding:4px 6px;border-radius:4px;cursor:pointer}
.sec:hover{background:var(--grid)}
.sec.active{background:var(--series);color:#fff}
table{border-collapse:collapse;margin-top:8px}
td,th{border:1px solid var(--grid);padding:4px 8px;text-align:left}
input,select,button{font:inherit;background:var(--surface);
 color:var(--ink);border:1px solid var(--grid);border-radius:4px;
 padding:3px 6px}
button{cursor:pointer}
button.danger{color:var(--accent)}
#err{color:var(--accent);min-height:1.3em;margin-top:8px}
.kindtag{font-size:11px;color:var(--ink2);margin-left:6px}
</style></head><body>
<div id="side">
 <h1>DSP Config Editor</h1>
 <div id="files"></div>
 <h2>Sections</h2><div id="secs"></div>
 <h2>New section</h2>
 <select id="newkind"><option>source</option><option>signal</option>
  <option>processing</option><option>workspace</option></select>
 <input id="newname" placeholder="name" size="10">
 <button onclick="addSection()">Add</button>
 <div id="err"></div>
</div>
<div id="main"><h1 id="title">select a section</h1><div id="detail"></div>
</div>
<script>
let FILE=0, CONF=null, SCHEMA=null, CUR=null;
async function j(url,opts){const r=await fetch(url,opts);return r.json()}
async function post(url,body){return j(url,{method:"POST",
 headers:{"Content-Type":"application/json"},body:JSON.stringify(body)})}
function err(e){document.getElementById("err").textContent=e||""}
async function refresh(){
 CONF=await j("/api/config?file="+FILE);
 const d=document.getElementById("secs");d.replaceChildren();
 for(const s of CONF.sections){
  const el=document.createElement("div");
  el.className="sec"+(CUR===s.name?" active":"");
  el.textContent=s.name;                       // names via textContent only
  const tag=document.createElement("span");
  tag.className="kindtag";tag.textContent=s.kind;el.appendChild(tag);
  el.onclick=()=>{CUR=s.name;refresh()};d.appendChild(el);}
 if(CONF.rejected_names)err("rejected invalid names: "+
  CONF.rejected_names.join(", "));
 render();}
function el(tag,...kids){const e=document.createElement(tag);
 for(const k of kids){e.append(k)}return e}
function render(){
 const s=CONF.sections.find(x=>x.name===CUR);
 document.getElementById("title").textContent=CUR||"select a section";
 const d=document.getElementById("detail");d.replaceChildren();
 if(!s)return;
 const known=SCHEMA.schemas[s.kind]||{};
 const tbl=document.createElement("table");
 tbl.appendChild(el("tr",el("th","key"),el("th","value"),el("th","type"),
  el("th","")));
 const keys=new Set([...Object.keys(known),...Object.keys(s.keys)]);
 for(const k of keys){
  const inp=document.createElement("input");
  inp.value=String(s.keys[k]??"");
  inp.onchange=()=>setKey(k,inp);
  const del=document.createElement("button");
  del.className="danger";del.textContent="x";del.onclick=()=>delKey(k);
  tbl.appendChild(el("tr",el("td",k),el("td",inp),
   el("td",known[k]||"str"),el("td",del)));}
 d.appendChild(tbl);
 const h=el("h2","Add key");
 const nk=document.createElement("input");nk.id="nk";nk.placeholder="key";
 const nv=document.createElement("input");nv.id="nv";nv.placeholder="value";
 const set=document.createElement("button");set.textContent="Set";
 set.onclick=()=>addKey();
 const ds=document.createElement("button");ds.className="danger";
 ds.textContent="Delete section";ds.onclick=()=>delSection();
 d.appendChild(el("div",h,nk," ",nv," ",set," ",ds));}
async function setKey(k,inp){const v=inp.value;
 const r=await post("/api/set",{file:FILE,section:CUR,key:k,value:v});
 err(r.error);refresh()}
async function addKey(){const k=document.getElementById("nk").value,
 v=document.getElementById("nv").value;
 const r=await post("/api/set",{file:FILE,section:CUR,key:k,value:v});
 err(r.error);refresh()}
async function delKey(k){
 const r=await post("/api/delkey",{file:FILE,section:CUR,key:k});
 err(r.error);refresh()}
async function addSection(){
 const kind=document.getElementById("newkind").value,
  name=document.getElementById("newname").value;
 const r=await post("/api/addsection",{file:FILE,kind:kind,name:name});
 err(r.error);if(r.section)CUR=r.section;refresh()}
async function delSection(){
 const r=await post("/api/delsection",{file:FILE,section:CUR});
 err(r.error);CUR=null;refresh()}
(async()=>{
 SCHEMA=await j("/api/schema");
 const fs=await j("/api/files");
 const fd=document.getElementById("files");
 for(const f of fs.files){const el=document.createElement("div");
  el.className="sec"+(f.index===FILE?" active":"");
  el.textContent=f.path;el.onclick=()=>{FILE=f.index;CUR=null;refresh()};
  fd.appendChild(el);}
 refresh();})();
</script></body></html>
"""


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="+", help="INI config files to edit")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8791)
    args = ap.parse_args(argv)
    editor = ConfigWebEditor(args.configs)
    srv = editor.make_server(args.host, args.port)
    print(f"config editor on http://{args.host}:{srv.server_address[1]}/")
    srv.serve_forever()


if __name__ == "__main__":
    main()
