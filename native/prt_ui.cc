// prt_ui.so — loadable LV2UI launcher for the browser GUI.
//
// The reference ships an embedded OpenGL LV2UI (gui/phaserotate.c:
// 1136-1309 descriptor, lv2ttl/manifest.gui.in).  The framework's
// graphical surface is the daemon-served browser page (phaserotate_tpu/
// gui/web.py): dials, gradient meters, link, reset-peaks — driven by the
// live engine over the real protocol.  This binary makes that surface a
// *host-visible UI*: the bundle manifest declares it for both plugin
// URIs, and a host that instantiates it gets the ui:showInterface
// contract — show() opens the user's browser at the daemon's UI URL
// (PHASEROTATE_TPU_UI_URL, default http://127.0.0.1:8626/).
//
// There is intentionally no embedded widget: the engine lives in another
// process, so an in-process drawing surface would only be a proxy.  The
// browser page IS the UI; this shim is the LV2-shaped handle to it.
// Set PHASEROTATE_TPU_UI_NO_OPEN=1 to suppress launching a browser
// (headless hosts / tests).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

extern "C" {

// Minimal LV2UI ABI declarations (lv2plug.in/ns/extensions/ui, ISC spec;
// layout frozen by the specification — independent declaration, same
// rationale as lv2_abi.h).
typedef void* LV2UI_Handle;
typedef void* LV2UI_Widget;
typedef void* LV2UI_Controller;
typedef void (*LV2UI_Write_Function)(LV2UI_Controller controller,
                                     uint32_t port_index,
                                     uint32_t buffer_size,
                                     uint32_t port_protocol,
                                     const void* buffer);

typedef struct {
  const char* URI;
  void* data;
} LV2_Feature_;

typedef struct LV2UI_Descriptor {
  const char* URI;
  LV2UI_Handle (*instantiate)(const struct LV2UI_Descriptor* descriptor,
                              const char* plugin_uri,
                              const char* bundle_path,
                              LV2UI_Write_Function write_function,
                              LV2UI_Controller controller,
                              LV2UI_Widget* widget,
                              const LV2_Feature_* const* features);
  void (*cleanup)(LV2UI_Handle ui);
  void (*port_event)(LV2UI_Handle ui, uint32_t port_index,
                     uint32_t buffer_size, uint32_t format,
                     const void* buffer);
  const void* (*extension_data)(const char* uri);
} LV2UI_Descriptor;

// ui:showInterface extension (LV2_UI__showInterface)
typedef struct {
  int (*show)(LV2UI_Handle ui);
  int (*hide)(LV2UI_Handle ui);
} LV2UI_Show_Interface;

// ui:idleInterface — some hosts require it alongside showInterface
typedef struct {
  int (*idle)(LV2UI_Handle ui);
} LV2UI_Idle_Interface;

}  // extern "C"

namespace {

constexpr const char* kUiUri = "urn:phaserotate-tpu:plugin#web_ui";

struct Ui {
  bool shown = false;

  const char* url() const {
    const char* u = getenv("PHASEROTATE_TPU_UI_URL");
    return (u && *u) ? u : "http://127.0.0.1:8626/";
  }

  void open_browser() {
    fprintf(stderr, "phaserotate_tpu UI: %s\n", url());
    if (getenv("PHASEROTATE_TPU_UI_NO_OPEN")) return;
    pid_t pid = fork();
    if (pid == 0) {
      // child: detach and hand off to the user's URL opener
      execlp("xdg-open", "xdg-open", url(), (char*)nullptr);
      _exit(127);  // no opener available: URL was printed above
    } else if (pid > 0) {
      int status;
      waitpid(pid, &status, 0);
    }
  }
};

LV2UI_Handle instantiate(const LV2UI_Descriptor*, const char*, const char*,
                         LV2UI_Write_Function, LV2UI_Controller,
                         LV2UI_Widget* widget, const LV2_Feature_* const*) {
  Ui* ui = new (std::nothrow) Ui();
  if (!ui) return nullptr;
  if (widget) *widget = nullptr;  // no embedded widget: browser UI
  return ui;
}

void cleanup(LV2UI_Handle h) { delete static_cast<Ui*>(h); }

void port_event(LV2UI_Handle, uint32_t, uint32_t, uint32_t, const void*) {
  // state flows engine->browser directly (gui/web.py /state); the
  // host-side port stream needs no mirroring here
}

int ui_show(LV2UI_Handle h) {
  Ui* ui = static_cast<Ui*>(h);
  if (!ui->shown) {
    ui->open_browser();
    ui->shown = true;
  }
  return 0;
}

int ui_hide(LV2UI_Handle h) {
  static_cast<Ui*>(h)->shown = false;  // browser tab is the user's
  return 0;
}

int ui_idle(LV2UI_Handle) { return 0; }

const LV2UI_Show_Interface kShow = {ui_show, ui_hide};
const LV2UI_Idle_Interface kIdle = {ui_idle};

const void* extension_data(const char* uri) {
  if (strcmp(uri, "http://lv2plug.in/ns/extensions/ui#showInterface") == 0)
    return &kShow;
  if (strcmp(uri, "http://lv2plug.in/ns/extensions/ui#idleInterface") == 0)
    return &kIdle;
  return nullptr;
}

const LV2UI_Descriptor kDescriptor = {
    kUiUri, instantiate, cleanup, port_event, extension_data,
};

}  // namespace

extern "C" __attribute__((visibility("default")))
const LV2UI_Descriptor* lv2ui_descriptor(uint32_t index) {
  return index == 0 ? &kDescriptor : nullptr;
}
