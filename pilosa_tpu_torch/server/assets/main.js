/* pilosa-tpu console: PQL REPL with keyboard history, cluster status,
 * and a schema browser — the same information surface the reference's
 * console exposes (query + timing + history + index dropdown +
 * cluster view), plus frame options per index from /schema. */
"use strict";
const $ = id => document.getElementById(id);
const getJSON = (path, cb) =>
  fetch(path).then(r => r.json()).then(cb).catch(() => {});

const PANES = ["query", "cluster", "schema"];
function show(pane) {
  for (const p of PANES) {
    $("pane-" + p).classList.toggle("active", p === pane);
    $("nav-" + p).classList.toggle("active", p === pane);
  }
  if (pane === "cluster") refreshStatus();
  if (pane === "schema") refreshSchemaPane();
}
for (const p of PANES) $("nav-" + p).onclick = () => show(p);

/* ---- console ---- */
const history = [];       // submitted queries, oldest first
let histIdx = 0;          // cursor for ArrowUp/ArrowDown recall
let histDraft = "";

function refreshIndexes() {
  getJSON("/schema", s => {
    const sel = $("index"), cur = sel.value;
    sel.innerHTML = "";
    for (const ix of (s.indexes || []))
      sel.add(new Option(ix.name, ix.name, false, ix.name === cur));
  });
}

function run() {
  const index = $("index").value, q = $("pql").value.trim();
  if (!index || !q) return;
  history.push(q);
  histIdx = history.length;
  const t0 = performance.now();
  fetch("/index/" + encodeURIComponent(index) + "/query",
        {method: "POST", body: q})
    .then(r => r.json().then(body => ({ok: r.ok, body})))
    .then(({ok, body}) => record(q, body, ok, performance.now() - t0))
    .catch(e => record(q, {error: String(e)}, false,
                       performance.now() - t0));
  $("pql").value = "";
  refreshIndexes();
}

function record(q, body, ok, ms) {
  const div = document.createElement("div");
  div.className = "entry" + (ok ? "" : " err");
  const head = document.createElement("div");
  head.className = "q";
  head.textContent = q;
  const t = document.createElement("em");
  t.textContent = ms.toFixed(1) + " ms";
  head.appendChild(t);
  const pre = document.createElement("pre");
  pre.textContent = JSON.stringify(body, null, 2);
  div.append(head, pre);
  $("history").prepend(div);
}

$("run").onclick = run;
$("pql").addEventListener("keydown", e => {
  if (e.key === "Enter" && !e.shiftKey) { e.preventDefault(); run(); }
  else if (e.key === "ArrowUp" && histIdx > 0) {
    if (histIdx === history.length) histDraft = $("pql").value;
    histIdx--;
    $("pql").value = history[histIdx];
    e.preventDefault();
  } else if (e.key === "ArrowDown" && histIdx < history.length) {
    histIdx++;
    $("pql").value = histIdx === history.length ? histDraft
                                                : history[histIdx];
    e.preventDefault();
  }
});

/* ---- cluster ---- */
function refreshStatus() {
  getJSON("/status", s => {
    const tbody = $("status");
    tbody.replaceChildren();
    for (const n of ((s.status || {}).nodes || [])) {
      const tr = document.createElement("tr");
      const st = n.state || "?";
      for (const text of [n.host, st,
                          (n.indexes || []).map(i => i.name).join(", ")]) {
        const td = document.createElement("td");
        td.textContent = text;
        tr.appendChild(td);
      }
      tr.children[1].className = st;
      tbody.appendChild(tr);
    }
  });
}

/* ---- schema browser ---- */
function refreshSchemaPane() {
  getJSON("/schema", s => {
    const root = $("schema");
    root.replaceChildren();
    for (const ix of (s.indexes || [])) {
      const box = document.createElement("div");
      box.className = "schema-index";
      const name = document.createElement("div");
      name.className = "name";
      name.textContent = ix.name;
      const small = document.createElement("small");
      small.textContent = (ix.frames || []).length + " frame(s)";
      name.appendChild(small);
      name.onclick = () => box.classList.toggle("closed");
      const frames = document.createElement("div");
      frames.className = "frames";
      const table = document.createElement("table");
      const head = document.createElement("tr");
      for (const h of ["frame", "rowLabel", "cacheType", "cacheSize",
                       "inverseEnabled", "timeQuantum"]) {
        const th = document.createElement("th");
        th.textContent = h;
        head.appendChild(th);
      }
      table.appendChild(head);
      for (const fr of (ix.frames || [])) {
        const tr = document.createElement("tr");
        const o = fr.options || {};
        for (const v of [fr.name, o.rowLabel, o.cacheType, o.cacheSize,
                         o.inverseEnabled, o.timeQuantum]) {
          const td = document.createElement("td");
          td.textContent = v === undefined ? "—" : String(v);
          tr.appendChild(td);
        }
        table.appendChild(tr);
      }
      frames.appendChild(table);
      box.append(name, frames);
      root.appendChild(box);
    }
    if (!root.children.length)
      root.textContent = "no indexes yet — create one via the API or " +
        'POST /index/{name}';
  });
}

/* ---- boot ---- */
getJSON("/version", v => $("version").textContent =
  "v" + (v.version || "?"));
refreshIndexes();
setInterval(() => {
  if ($("pane-cluster").classList.contains("active")) refreshStatus();
}, 5000);
