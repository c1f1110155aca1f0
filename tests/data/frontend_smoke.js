/* Frontend smoke: execute frontend/js/app.js in a real JS engine against a
 * minimal DOM shim, render one full /api/process-all result (image cards,
 * speedup badge, canvas charts, categorized metric table) and simulate a
 * chart hover.
 *
 * Engine-agnostic (VERDICT r3 item 8): runs under node/bun
 * (`node frontend_smoke.js app.js`), deno
 * (`deno run --allow-read frontend_smoke.js app.js`), and quickjs
 * (`qjs --std frontend_smoke.js app.js`).  The pytest wrapper
 * (tests/test_frontend.py::test_frontend_executes_in_js_engine) probes all
 * of them and skips cleanly when the image carries none; the regex-level
 * contract tests still guard the logic there.
 */

/* ------------------------------------------------- engine portability */

const ENGINE =
  typeof Deno !== "undefined" ? "deno"
    : typeof scriptArgs !== "undefined" ? "qjs"
      : "node"; // node + bun (bun is node-compatible here)

function readTextFile(path) {
  if (ENGINE === "deno") return Deno.readTextFileSync(path);
  if (ENGINE === "qjs") {
    const txt = std.loadFile(path); // requires qjs --std
    if (txt === null) throw new Error(`cannot read ${path}`);
    return txt;
  }
  return require("fs").readFileSync(path, "utf8");
}

const APP_PATH =
  ENGINE === "deno" ? Deno.args[0]
    : ENGINE === "qjs" ? scriptArgs[1]
      : process.argv[2];

// Local assert: node's require("assert") is unavailable in deno/qjs.
const assert = {
  ok(cond, msg) { if (!cond) throw new Error(`assert: ${msg || "failed"}`); },
  strictEqual(a, b, msg) {
    if (a !== b) throw new Error(`assert: ${msg || ""}: ${a} !== ${b}`);
  },
};

/* ------------------------------------------------------------- DOM shim */

class Ctx2D {
  constructor() { this.calls = []; }
  _rec(name, args) { this.calls.push([name, ...args]); }
  clearRect(...a) { this._rec("clearRect", a); }
  fillText(...a) { this._rec("fillText", a); }
  fillRect(...a) { this._rec("fillRect", a); }
  strokeRect(...a) { this._rec("strokeRect", a); }
  beginPath() {}
  moveTo() {}
  lineTo() {}
  stroke() {}
  measureText(t) { return { width: String(t).length * 6 }; }
}

class El {
  constructor(tag) {
    this.tagName = String(tag || "div").toUpperCase();
    this.children = [];
    this.style = {};
    this.hidden = false;
    this.className = "";
    this.innerHTML = "";
    this.textContent = "";
    this.value = "0";
    this.checked = false;
    this.disabled = false;
    this._listeners = {};
    if (this.tagName === "CANVAS") {
      this.width = 460;
      this.height = 260;
      this._ctx = new Ctx2D();
    }
  }
  addEventListener(type, fn) {
    (this._listeners[type] = this._listeners[type] || []).push(fn);
  }
  fire(type, ev) { for (const f of this._listeners[type] || []) f(ev || {}); }
  append(...els) { this.children.push(...els); }
  appendChild(el) { this.children.push(el); }
  remove() {}
  querySelectorAll() { return []; }
  getContext() { return this._ctx; }
  getBoundingClientRect() {
    return { left: 0, top: 0, width: this.width || 100, height: this.height || 100 };
  }
  click() {}
}

const byId = {};
// Every id app.js drives (mirrors frontend/index.html).
for (const id of [
  "health", "dropzone", "fileInput", "sigma", "sigmaVal", "radius",
  "radiusVal", "filterSelect", "sigmaField", "radiusField", "profiling",
  "processBtn", "spinner", "error", "results", "imageGrid", "speedupBadge",
  "metricsTable", "lbClose", "lbPrev", "lbNext", "lightbox", "lbImg",
  "lbCaption",
]) byId[id] = new El(id.endsWith("Chart") ? "canvas" : "div");
byId.timeChart = new El("canvas");
byId.bwChart = new El("canvas");
byId.chartTip = new El("div");
byId.chartTip.hidden = true; // the HTML ships it hidden
byId.lightbox.hidden = true;

globalThis.document = {
  getElementById: (id) => byId[id] || null,
  createElement: (tag) => new El(tag),
  addEventListener: () => {},
  body: new El("body"),
};
globalThis.window = { addEventListener: () => {} };
globalThis.location = {
  protocol: "http:", hostname: "localhost", search: "",
  href: "http://localhost:8080/",
};
globalThis.FileReader = class { readAsDataURL() {} };
globalThis.fetch = () => Promise.reject(new Error("no network in smoke"));
if (typeof URL === "undefined") {
  // quickjs has no URL; app.js only needs .protocol/.hostname/.origin for
  // the ?api= override, which the empty location.search never exercises
  // here -- a throwing stub keeps resolveApiBase()'s catch path honest.
  globalThis.URL = class { constructor() { throw new Error("no URL"); } };
}
if (typeof URLSearchParams === "undefined") {
  globalThis.URLSearchParams = class { get() { return null; } };
}

/* --------------------------------------------------- load the real app.js */

// INDIRECT eval ((0, eval)): runs app.js in the global scope with sloppy
// semantics even when this harness is loaded as a strict ES module (deno).
// Its function declarations land on globalThis (renderResults, ...); their
// closures keep app.js's own lexical consts ($ , state, METRIC_SECTIONS).
(0, eval)(readTextFile(APP_PATH));

/* ------------------------------------------------------------ assertions */

const body = {
  original_image: "data:image/png;base64,xxxx",
  image_info: { width: 100, height: 80, channels: 3 },
  results: {
    level_1: {
      info: { level: "Reference (Naive)", level_number: 1 },
      processed_image: "data:image/png;base64,yyyy",
      metrics: {
        time_ms: 1.5,
        bandwidth_gbps: 10.0,
        fps: 666.0,
        kernel_durations: [0.9, 0.6],
        kernels_profiled: [
          "gaussian_blur_fused_l1_horizontal",
          "gaussian_blur_fused_l1_vertical",
        ],
        kernel_duration_source: "isolated_pass_estimate",
        ncu_data: {
          memory: { "HLO Bytes Accessed": 123456, "Exotic Counter": 7 },
          config: { Platform: "gpu" },
        },
      },
    },
    level_2: {
      info: { level: "GPU Optimized", level_number: 2 },
      processed_image: "data:image/png;base64,zzzz",
      metrics: { time_ms: 0.5, bandwidth_gbps: 30.0, fps: 2000.0 },
    },
  },
};

renderResults(body, "gaussian");

// Image cards: original + one per level.
assert.strictEqual(byId.imageGrid.children.length, 3, "image cards");

// Speedup badge from real time_ms.
assert.strictEqual(byId.speedupBadge.hidden, false);
assert.ok(byId.speedupBadge.textContent.includes("3.00"),
  `speedup badge: ${byId.speedupBadge.textContent}`);

// Categorized metric table renders the common keys, the per-pass
// expansion, and the Other sweep for unmapped deep entries.
const html = byId.metricsTable.innerHTML;
for (const needle of [
  "Execution time (ms)", "Modeled bandwidth (GB/s)", "Throughput (fps)",
  "horizontal pass", "vertical pass", "estimated (isolated passes)",
  "HLO bytes accessed", "Exotic Counter", "Other",
]) assert.ok(html.includes(needle), `metric table missing: ${needle}`);

// Charts drew bars and recorded hover geometry.
for (const cv of [byId.timeChart, byId.bwChart]) {
  assert.ok(cv._chart, "chart state");
  assert.strictEqual(cv._chart.rects.length, 2, "bar rects");
  assert.ok(cv._ctx.calls.some((c) => c[0] === "fillRect"), "bars drawn");
}

// Hover over bar 0: highlight redraw + tooltip with label, value, unit.
const b0 = byId.timeChart._chart.rects[0];
byId.timeChart.fire("mousemove", {
  clientX: b0.x + b0.w / 2, clientY: b0.y + b0.h / 2, pageX: 40, pageY: 40,
});
assert.strictEqual(byId.chartTip.hidden, false, "tooltip shown");
assert.ok(byId.chartTip.textContent.includes("1.500"),
  `tooltip value: ${byId.chartTip.textContent}`);
assert.ok(byId.chartTip.textContent.includes("ms"), "tooltip unit");
assert.ok(
  byId.timeChart._ctx.calls.some((c) => c[0] === "strokeRect"),
  "hover highlight drawn");

// Leaving the canvas hides the tooltip again.
byId.timeChart.fire("mouseleave", {});
assert.strictEqual(byId.chartTip.hidden, true, "tooltip hidden on leave");

// Legend click toggles the dataset (Chart.js default-legend parity:
// one item per dataset, strike-through + hidden bars while off).
const lg = byId.timeChart._chart.legendRect;
assert.ok(lg, "legend rect recorded");
byId.timeChart.fire("click", { clientX: lg.x + 2, clientY: lg.y + 2 });
assert.strictEqual(byId.timeChart._chart.hidden, true, "legend toggles off");
assert.strictEqual(byId.timeChart._chart.rects.length, 0, "no bars while hidden");
byId.timeChart.fire("click", { clientX: lg.x + 2, clientY: lg.y + 2 });
assert.strictEqual(byId.timeChart._chart.hidden, false, "legend toggles back");
assert.strictEqual(byId.timeChart._chart.rects.length, 2, "bars restored");
// Re-render keeps the toggle state (Chart.js keeps it across updates).
byId.timeChart.fire("click", { clientX: lg.x + 2, clientY: lg.y + 2 });
renderResults(body, "gaussian");
assert.strictEqual(byId.timeChart._chart.hidden, true, "toggle survives render");
byId.timeChart.fire("click", { clientX: lg.x + 2, clientY: lg.y + 2 });

// Lightbox open/step/close cycle on the rendered cards.
openLightbox(0);
assert.strictEqual(byId.lightbox.hidden, false);
stepLightbox(1);
assert.ok(byId.lbCaption.textContent.length > 0, "lightbox caption");
closeLightbox();
assert.strictEqual(byId.lightbox.hidden, true);

console.log("SMOKE OK");
